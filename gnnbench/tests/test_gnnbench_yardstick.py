"""The benchmark's frozen pieces: the generator repeats from its seed, the
feed's batches, and the operation and byte counts at the cells' shapes."""

import numpy as np
import pytest
import torch

from gnnbench.traffic import products_like
from gnnbench.traffic.roots import RootFeed
from gnnbench.yardstick import counts, trace

SPEC = {"num_nodes": 2000, "undirected_edges": 20000, "intra_share": 0.75,
        "feat_dim": 6, "num_classes": 4, "signal": 1.0}


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("offsets", "neighbors", "features", "labels",
                         "train_rows"))


def test_generator_repeats_from_its_seed():
    a = products_like.generate(SPEC, 2 ** 31 + 7, "cpu")
    b = products_like.generate(SPEC, 2 ** 31 + 7, "cpu")
    c = products_like.generate(SPEC, 2 ** 31 + 8, "cpu")
    assert _same(a, b)
    assert not torch.equal(a.neighbors[:100], c.neighbors[:100])


def test_generator_builds_the_csr_of_an_undirected_graph():
    g = products_like.generate(SPEC, 5, "cpu")
    n = g.num_nodes
    src = torch.repeat_interleave(torch.arange(n), g.offsets.diff())
    key = src * n + g.neighbors.long()
    # rows ascending, no repeats, every edge both ways
    assert bool((key.diff() > 0).all())
    back = g.neighbors.long() * n + src
    assert torch.equal(torch.sort(back).values, key)
    assert g.neighbors.numel() <= 2 * SPEC["undirected_edges"]
    per_class = max(20, n // (SPEC["num_classes"] * 10))
    assert g.train_rows.numel() == per_class * SPEC["num_classes"]


def test_feed_repeats_and_never_repeats_a_root_in_a_batch():
    pool = np.arange(100, 1100, dtype=np.int32)
    a = RootFeed(pool, 300, 2 ** 40, 9, keep=(1, 2))
    b = RootFeed(pool, 300, 2 ** 40, 9)
    for _ in range(7):
        x, y = next(a), next(b)
        assert np.array_equal(x["roots"], y["roots"])
        assert x["sample_seed"] == y["sample_seed"]
        assert len(np.unique(x["roots"])) == 300
    assert len(a.kept) == 2 and a.kept[1]["sample_seed"] == 12
    # an epoch (3 batches of the 1,000 rows) visits a root at most once
    c = RootFeed(pool, 300, 7, 9)
    epoch = np.concatenate([next(c)["roots"] for _ in range(3)])
    assert len(np.unique(epoch)) == 900


def test_model_flops_at_the_cells_shapes():
    b, fan = 32768, [25, 10]
    # layer 0: self and neighbor transforms 100 → 128 over 26 B rows,
    # forward and weight gradient; layer 1 (256 → 128, both) and the
    # 47 logits: forward and both gradients
    sup = (2 * 2 * 100 * 128 * 26 * b * 2 + 2 * 2 * 256 * 128 * b * 3
           + 2 * 256 * 47 * b * 3)
    assert counts.sage_step_flops(b, fan, 100, 128, True, 47,
                                  "logits") == sup
    assert sup == 102_492_012_544  # "102.5 GFLOP a step"
    # unsupervised: layer 1 is 128 → 128, six dot products of 128 a root
    uns = (2 * 2 * 100 * 128 * 26 * b * 2 + 2 * 2 * 128 * 128 * b * 3
           + 2 * 6 * 128 * b * 3)
    assert counts.sage_step_flops(b, fan, 100, 128, False, 6,
                                  "scores") == uns
    assert uns == 93_834_969_088  # "93.8 GFLOP"
    with pytest.raises(ValueError):
        counts.sage_step_flops(b, fan, 100, 128, False, 6, "softmax")


def test_gather_mean_bytes_at_the_launch_shapes():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert peak["hbm_bytes_per_s"] == 3.35e12
    table = torch.zeros((2_449_030, 100), dtype=torch.int8)
    rows = torch.zeros((819_200, 10), dtype=torch.int32)
    rows[:, :] = torch.arange(819_200, dtype=torch.int32)[:, None] * 4
    scale = torch.ones(100, dtype=torch.bfloat16)
    out = torch.bfloat16
    assert counts.payload_bytes(table, rows, out) == (
        819_200 * 10 * 100 + 819_200 * 10 * 4 + 819_200 * 100 * 2)
    b = counts.gather_mean_bound(table, rows, scale, out, peak)
    want = 819_200 * 10 * 4 + 819_200 * 100 + 200 + 819_200 * 100 * 2
    assert b["bytes"] == want and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)


def test_trace_reduction_counts_overlap_once():
    dev = [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "gather_mean")]
    host = [(0.0, 100.0, "outer"), (22.0, 28.0, "inner")]
    assert trace.busy_seconds(dev) == pytest.approx(30e-6)
    gaps = trace.idle_gaps(dev, host, (0.0, 50.0))
    assert gaps[0] == ["inner", pytest.approx(10e-6)]
    assert trace.mean_kernel_ms(dev, "gather_mean") == pytest.approx(0.01)
    assert trace.mean_kernel_ms(dev, "nothing") is None
    assert trace.top_ops(dev)[0] == ["b", pytest.approx(15e-6)]
