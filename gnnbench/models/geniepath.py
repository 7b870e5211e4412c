"""The GeniePath family: `DeviceSampledGraphSage(encoder="genie")` trained
by `NodeEstimator.train` at steps_per_loop K through the K-step CUDA
graph, on the tables training.SampledProgram builds (the labels one-hot
in the feature store), as the supervised GraphSAGE family trains. The
plain reference is reference/geniepath.py.

`run` also reads the estimator's phase histograms
(estimator_phase_device_ms, one child a phase, the genie encoder's
gather / breadth / depth among them): the deltas (count, sum) of each
`train` call, and puts the timed window's, the run's third call, into
the record as `phases`.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from gnnbench import training
from gnnbench.reference.geniepath import ENC, LSTM, Reference
from gnnbench.yardstick.genie_counts import genie_step_flops

# the run's train calls: the warm-up, the checked replay, the window
WINDOW_CALL = 2


def weight_specs(cfg: dict):
    """(name, shape, kind) of every parameter, in the program's names.
    Every weight is lecun (flax starts the attention's query as
    normal(0.1) and the LSTM's recurrent kernels orthogonal; the
    benchmark draws all of them one way)."""
    m, g = cfg["model"], cfg["graph"]
    dim, hops = int(m["dim"]), len(m["fanouts"])

    def dense(name, fan_in, bias=True):
        return [(f"{name}.weight", (dim, fan_in), "lecun")] + (
            [(f"{name}.bias", (dim,), "zeros")] if bias else [])

    specs = dense(f"{ENC}.proj", int(g["feat_dim"]))
    for d in range(hops + 1):
        specs += dense(f"{ENC}.depth_fc_{d}", dim)
    for t in range(hops):
        specs += [(f"{ENC}.att_{t}.query", (dim,), "lecun")]
        specs += dense(f"{ENC}.att_{t}.key", dim)
        for hop in range(hops - t):
            specs += dense(f"{ENC}.w_{t}_{hop}", dim)
    for gate in "ifgo":
        specs += dense(f"{LSTM}.i{gate}", dim, bias=False)
        specs += dense(f"{LSTM}.h{gate}", dim)
    c = int(g["num_classes"])
    return specs + [("out.weight", (c, dim), "lecun"),
                    ("out.bias", (c,), "zeros")]


def step_flops(cfg: dict, wl: dict) -> int:
    m, g = cfg["model"], cfg["graph"]
    return genie_step_flops(int(wl["batch_size"]), m["fanouts"],
                            int(g["feat_dim"]), int(m["dim"]),
                            int(g["num_classes"]))["total"]


def host_inputs(graph, cfg: dict) -> dict:
    return training.host_arrays(graph, int(cfg["graph"]["num_classes"]))


def _phase_totals() -> Dict[str, List[float]]:
    """{phase: [count, sum ms]} of estimator_phase_device_ms over every
    estimator of the process (a run builds one)."""
    from euler_tpu_torch import obs

    snap = obs.default_registry().snapshot(run_collectors=False)
    out: Dict[str, List[float]] = {}
    for labels, v in snap.get("estimator_phase_device_ms", {}) \
            .get("values", {}).items():
        phase = labels.split("phase=")[1].split(",")[0]
        c, s = out.get(phase, (0, 0.0))
        out[phase] = [c + v["count"], s + v["sum"]]
    return out


def _with_phase_deltas(train, calls: List[dict]):
    """`train` that appends each call's phase deltas to `calls`."""

    @functools.wraps(train)
    def wrapped(*args, **kwargs):
        before = _phase_totals()
        try:
            return train(*args, **kwargs)
        finally:
            calls.append({p: [c - before.get(p, (0, 0.0))[0],
                              s - before.get(p, (0, 0.0))[1]]
                          for p, (c, s) in _phase_totals().items()})

    return wrapped


class Program(training.SampledProgram):
    def __init__(self, *args, calls: Optional[List[dict]] = None):
        # set before the base class builds the estimator
        self.calls = calls
        super().__init__(*args)

    def estimator(self, cfg: dict, wl: dict, params: dict):
        from euler_tpu_torch.estimator.estimators import NodeEstimator
        from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage

        m, g = cfg["model"], cfg["graph"]
        with torch.device(self.device):
            model = DeviceSampledGraphSage(
                int(g["num_classes"]), int(g["feat_dim"]), multilabel=False,
                dim=int(m["dim"]), fanouts=self.fanouts,
                encoder=m["encoder"],
                uniform_sampling=self.table.uniform_rows)
        est = NodeEstimator(
            model, {**params, "batch_size": int(wl["batch_size"]),
                    "train_node_type": -1},
            None, None, feature_store=self.store, device_sampler=self.table,
            device=self.device)
        if self.calls is not None:
            est.train = _with_phase_deltas(est.train, self.calls)
        return est

    def draw(self, batch: dict):
        """[roots, hop 1, hop 2]: the model's own draw for a batch."""
        return self.est.model.sample_rows({**self.est.static_batch,
                                           **batch})


def run(ctx) -> dict:
    """training.run of this family, with the timed window's phase deltas
    in the record as `phases` ({phase: [count, sum ms]})."""
    calls: List[dict] = []
    family = SimpleNamespace(
        Program=functools.partial(Program, calls=calls),
        Reference=Reference, weight_specs=weight_specs,
        step_flops=step_flops, host_inputs=host_inputs)
    rec = training.run(ctx, family)
    if len(calls) > WINDOW_CALL:
        rec["phases"] = calls[WINDOW_CALL]
    return rec
