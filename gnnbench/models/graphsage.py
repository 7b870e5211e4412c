"""The supervised GraphSAGE family: `DeviceSampledGraphSage` trained by
`NodeEstimator.train` at steps_per_loop K through the K-step CUDA graph,
on the tables training.SampledProgram builds (the labels one-hot in
the feature store). The plain reference is reference/graphsage.py.
"""

from __future__ import annotations

import sys

import torch

from gnnbench import training
from gnnbench.reference.graphsage import ENC, Reference  # noqa: F401
from gnnbench.yardstick import counts


def weight_specs(cfg: dict):
    """(name, shape, kind) of every parameter, in the program's names."""
    specs, width = training.encoder_specs(ENC, cfg)
    c = int(cfg["graph"]["num_classes"])
    return specs + [("out.weight", (c, width), "lecun"),
                    ("out.bias", (c,), "zeros")]


def step_flops(cfg: dict, wl: dict) -> int:
    m, g = cfg["model"], cfg["graph"]
    return counts.sage_step_flops(int(wl["batch_size"]), m["fanouts"],
                                  int(g["feat_dim"]), int(m["dim"]),
                                  concat=bool(m["concat"]),
                                  head=int(g["num_classes"]),
                                  head_kind="logits")


def host_inputs(graph, cfg: dict) -> dict:
    return training.host_arrays(graph, int(cfg["graph"]["num_classes"]))


class Program(training.SampledProgram):
    def estimator(self, cfg: dict, wl: dict, params: dict):
        from euler_tpu_torch.estimator.estimators import NodeEstimator
        from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage

        m, g = cfg["model"], cfg["graph"]
        with torch.device(self.device):
            model = DeviceSampledGraphSage(
                int(g["num_classes"]), int(g["feat_dim"]), multilabel=False,
                dim=int(m["dim"]), fanouts=self.fanouts,
                aggregator=m["aggregator"],
                uniform_sampling=self.table.uniform_rows)
        return NodeEstimator(
            model, {**params, "batch_size": int(wl["batch_size"]),
                    "train_node_type": -1},
            None, None, feature_store=self.store, device_sampler=self.table,
            device=self.device)

    def draw(self, batch: dict):
        """[roots, hop 1, hop 2]: the model's own draw for a batch."""
        return self.est.model.sample_rows({**self.est.static_batch,
                                           **batch})


def run(ctx) -> dict:
    return training.run(ctx, sys.modules[__name__])
