"""The unsupervised GraphSAGE family: `DeviceSampledUnsupervisedSage` in a
plain `BaseEstimator`, trained by `BaseEstimator.train` at
steps_per_loop K through the K-step CUDA graph, on the tables
training.SampledProgram builds and the negatives' node sampler,
`DeviceNodeSampler.from_arrays` over every node at unit weight. The
plain reference is reference/unsup_sage.py.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnnbench import training
from gnnbench.reference.unsup_sage import CTX, ENC, Reference  # noqa: F401
from gnnbench.yardstick import counts


def weight_specs(cfg: dict):
    """(name, shape, kind) of every parameter, in the program's names."""
    specs, width = training.encoder_specs(ENC, cfg)
    kind = ("uniform", float(cfg["model"]["context_init_scale"]))
    return specs + [(CTX, (int(cfg["graph"]["num_nodes"]) + 1, width),
                     kind)]


def step_flops(cfg: dict, wl: dict) -> int:
    m, g = cfg["model"], cfg["graph"]
    return counts.sage_step_flops(int(wl["batch_size"]), m["fanouts"],
                                  int(g["feat_dim"]), int(m["dim"]),
                                  concat=bool(m["concat"]),
                                  head=1 + int(m["num_negs"]),
                                  head_kind="scores")


def host_inputs(graph, cfg: dict) -> dict:
    return training.host_arrays(graph)


class Program(training.SampledProgram):
    def node_tables(self, cfg: dict) -> None:
        from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler

        self.neg = DeviceNodeSampler.from_arrays(
            np.ones(int(cfg["graph"]["num_nodes"]), np.float32),
            device=self.device)

    def estimator(self, cfg: dict, wl: dict, params: dict):
        from euler_tpu_torch.estimator.base_estimator import BaseEstimator
        from euler_tpu_torch.models.graphsage import (
            DeviceSampledUnsupervisedSage,
        )

        m, g = cfg["model"], cfg["graph"]
        with torch.device(self.device):
            model = DeviceSampledUnsupervisedSage(
                int(g["num_nodes"]), int(g["feat_dim"]), dim=int(m["dim"]),
                fanouts=self.fanouts, aggregator=m["aggregator"],
                num_negs=int(m["num_negs"]),
                uniform_sampling=self.table.uniform_rows)
        est = BaseEstimator(model, params, device=self.device)
        est.static_batch.update({
            "feature_table": self.store.features,
            "feature_scale": self.store.feature_scale,
            **self.table.tables, **self.neg.tables})
        return est

    def draw(self, batch: dict):
        """[roots, hop 1, hop 2, positives, negatives]: the model's own
        draw for a batch."""
        rows, pos, negs = self.est.model.sample({**self.est.static_batch,
                                                 **batch})
        return list(rows) + [pos, negs]


def run(ctx) -> dict:
    return training.run(ctx, sys.modules[__name__])
