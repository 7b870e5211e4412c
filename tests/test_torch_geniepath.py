"""GeniePath on the port's device-sampled path against the benchmark's
plain reference (gnnbench/reference/geniepath.py), on the CPU at a small
size: DeviceSampledGraphSage(encoder="genie") and its Adam trained by
NodeEstimator.train, as the geniepath_products cell builds them
(gnnbench/models/geniepath.py), and the reference from the same seeded
weights, over three steps; and the genie encoder's forward phases in
the estimator's phase histograms."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)

import numpy as np
import pytest
import torch

from euler_tpu_torch import obs
from euler_tpu_torch.obs import device
from gnnbench import training
from gnnbench.models import geniepath, graphsage
from gnnbench.reference.geniepath import Reference
from gnnbench.traffic import products_like

CFG = {
    "family": "geniepath", "precision": "float32",
    "graph": {"generator": "products_like", "num_nodes": 1500,
              "undirected_edges": 12000, "intra_share": 0.75,
              "feat_dim": 12, "num_classes": 5, "signal": 1.0},
    "model": {"encoder": "genie", "dim": 16, "fanouts": [4, 3],
              "neighbor_cap": 16, "feature_values": "int8",
              "feature_scale": "bfloat16"},
    "optimizer": {"name": "adam", "learning_rate": 0.003, "b1": 0.9,
                  "b2": 0.999, "eps": 1e-8},
}
WL = {"batch_size": 64, "steps_per_loop": 1, "log_steps": 100}
STEPS, GRAPH_SEED, TABLE_SEED, WEIGHT_SEED = 3, 21, 5, 9
CPU = torch.device("cpu")

# Float32 tolerances of the program against the reference. The two
# compute the same equations in another order (the LSTM's four gates as
# one GEMM or four, the attention's pool as a batched product or a
# weighted sum, the loss over one-hot or integer labels), so each value
# rounds apart by a few float32 ulps (1.2e-7 relative) and three Adam
# steps carry that into the weights. In these units the program read at
# most 4.3e-7 over five graph and weight seeds at this size; half of the
# batch left out of the loss read at least 1.4e-3 (the losses) and 0.11
# (the moment, the change).
# - the losses: relative, 100 ulps of float32;
LOSS_TOL = 1e-5
# - Adam's first moment and each parameter's change, the worst leaf's
#   relative gap (training.numbers): Adam divides by the root of the
#   second moment, so a gradient element near zero moves its step by
#   more than its own rounding: 1e-4, 1000 ulps.
LEAF_TOL = 1e-4


def _values(name, **labels):
    snap = obs.snapshot().get(name, {}).get("values", {})
    want = {f"{k}={v}" for k, v in labels.items()}
    return {k: v for k, v in snap.items() if want <= set(k.split(","))}


def _phase_counts(est):
    return {k.split("phase=")[1]: v["count"] for k, v in _values(
        "estimator_phase_device_ms", estimator=est._obs_name).items()}


def _batches(graph):
    rng = np.random.default_rng(7)
    pool = graph.train_rows.to(torch.int32).numpy()
    return [{"roots": rng.choice(pool, WL["batch_size"], replace=False),
             "sample_seed": 1000 + i} for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    """(the program's observations over the steps, the reference's, the
    reference's with half of the batch left out, the program's
    estimator)."""
    graph = products_like.generate(CFG["graph"], GRAPH_SEED, CPU)
    prog = geniepath.Program(geniepath.host_inputs(graph, CFG), CFG, WL,
                             CPU, TABLE_SEED)

    def weights():
        return training.make_weights(geniepath.weight_specs(CFG),
                                     WEIGHT_SEED, CPU)

    batches = _batches(graph)
    mine = training.checked_replay(
        prog.est, iter([prog.batch(b) for b in batches]), weights, STEPS)
    picks = training.program_picks(prog, [prog.batch(b) for b in batches])
    ref = Reference(CFG, graph, TABLE_SEED, weights(), CPU)
    theirs = training.follow(ref, batches, CPU, against=picks)
    ref.start(weights(), fault="half_batch")
    half = training.follow(ref, batches, CPU)
    mine["picks_mismatch"] = theirs["picks_mismatch"]
    return mine, theirs, half, prog.est


def test_the_draws_equal_the_references(runs):
    mine, theirs, _, _ = runs
    assert mine["picks_mismatch"] == 0
    assert len(theirs["losses"]) == STEPS


def test_the_steps_follow_the_reference_in_float32(runs):
    mine, theirs, _, _ = runs
    n = training.numbers(mine, theirs)
    assert n["loss_gap"] <= LOSS_TOL, n
    assert n["moment_gap"] <= LEAF_TOL, n
    assert n["change_gap"] <= LEAF_TOL, n


def test_half_the_batch_fails_the_tolerances(runs):
    mine, _, half, _ = runs
    n = training.numbers(mine, half)
    assert n["loss_gap"] > LOSS_TOL and n["moment_gap"] > LEAF_TOL \
        and n["change_gap"] > LEAF_TOL, n


def test_the_genie_forward_phases_are_observed_once_a_step(runs):
    """The genie estimator reads gather, breadth and depth beside the
    four phases, once a step; a sage estimator on the same tables reads
    the four alone."""
    est = runs[3]
    counts = _phase_counts(est)
    assert set(counts) == set(device.PHASES + device.FORWARD_PHASES)
    assert set(counts.values()) == {STEPS}
    graph = products_like.generate(CFG["graph"], GRAPH_SEED, CPU)
    sage_cfg = {**CFG, "model": {**CFG["model"], "aggregator": "mean"}}
    sage = graphsage.Program(graphsage.host_inputs(graph, sage_cfg),
                             sage_cfg, WL, CPU, TABLE_SEED).est
    sage.train(iter([{"rows": [torch.from_numpy(b["roots"])],
                      "sample_seed": b["sample_seed"]}
                     for b in _batches(graph)]), max_steps=STEPS)
    counts = _phase_counts(sage)
    assert set(counts) == set(device.PHASES)
    assert set(counts.values()) == {STEPS}


def test_a_mark_of_an_unknown_phase_raises():
    """A mark writes a slot of a buffer sized for the known phases."""
    hist = obs.default_registry().histogram("test_genie_phase_ms", "",
                                            ("phase",))
    rec = device.PhaseRecorder(CPU, lambda p: hist.labels(phase=p))
    with rec.update():
        device.mark("gather")
        with pytest.raises(ValueError, match="unknown phase"):
            device.mark("attention")
