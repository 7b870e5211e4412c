"""The plain reference agrees with the port on the CPU at a tiny size:
piece by piece (the rebuilt tables, the draws), and over the three
checked steps of a whole run of each tiny cell."""

import json

import numpy as np
import pytest
import torch

from gnnbench.reference import common
from gnnbench.traffic import products_like

import tiny_root

SPEC = {"num_nodes": 1500, "undirected_edges": 24000, "intra_share": 0.75,
        "feat_dim": 7, "num_classes": 3, "signal": 1.0}


def test_rebuilt_tables_equal_the_ports():
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import quantize_int8

    g = products_like.generate(SPEC, 77, "cpu")
    cap = 12  # most rows are hubs: the weighted choice decides them
    for seed in (0, 2 ** 62 + 3):
        port = DeviceNeighborTable.from_csr(
            g.offsets.numpy(), g.neighbors.numpy(), cap=cap, seed=seed,
            device="cpu")
        ref = common.neighbor_table(g.offsets, g.neighbors, cap, seed)
        assert torch.equal(port.neighbors.long(), ref)
    feats = torch.cat([g.features, torch.zeros(1, 7)])
    q, scale = quantize_int8(feats.numpy())
    rq, rscale = common.quantize_int8(feats)
    assert np.array_equal(q, rq.numpy()) and np.array_equal(
        scale, rscale.numpy())


def test_reference_draws_equal_the_ports():
    from euler_tpu_torch.models.graphsage import sample_seed_generator
    from euler_tpu_torch.parallel.device_sampler import (
        DeviceNeighborTable, sample_hop,
    )

    g = products_like.generate(SPEC, 78, "cpu")
    table = DeviceNeighborTable.from_csr(g.offsets.numpy(),
                                         g.neighbors.numpy(), cap=12,
                                         device="cpu")
    ref = common.neighbor_table(g.offsets, g.neighbors, 12, 0)
    rows = torch.arange(0, 1500, 7, dtype=torch.int32)
    gen = sample_seed_generator(123456, torch.device("cpu"), 17)
    port = sample_hop(table.neighbors, table.cum_weights, rows, 5,
                      generator=gen, uniform=True)
    mine = common.uniform_hop(ref, rows, 5, common.stream(17, 123456, "cpu"))
    assert torch.equal(port.long(), mine)


@pytest.mark.parametrize("cell", sorted(tiny_root.CELLS))
def test_a_tiny_run_is_correct(tmp_path, cell):
    root = tiny_root.make_root(tmp_path)
    out = tiny_root.run_in(root, tiny_root.run_cell_code(cell, 2 ** 31 + 5))
    res = json.loads(out.splitlines()[-2])
    assert res["correct"], res["checks"]
    assert res["checks"]["picks_mismatch"]["value"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0
    assert set(res["metrics"]) == {"train_roots_per_s", "setup_s"}
