"""Device neighbor tables and draws of the PyTorch port against the JAX
package (euler_tpu/parallel/device_sampler.py), on the CPU: tables
byte-identical from the same CSR, picks bit-exact with the uniforms
JAX draws replayed."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataset.base_dataset import synthetic_citation as jax_synth
from euler_tpu.parallel import device_sampler as J
from euler_tpu_torch.dataset.synthetic import synthetic_citation, to_csr
from euler_tpu_torch.parallel import device_sampler as P

CAP = 8

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time
_O0 = {"xla_backend_optimization_level": 0}


def _csr(seed=0, n=300, weighted=True):
    """Random CSR with degrees 0..3·CAP (hubs above CAP), a few
    zero-weight edges, and one all-zero-weight hub."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 3 * CAP, n)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, offsets[-1]).astype(np.int32)
    if not weighted:
        return offsets, nbrs, np.ones(len(nbrs), np.float32)
    ws = rng.uniform(0.1, 5.0, len(nbrs)).astype(np.float32)
    ws[rng.random(len(nbrs)) < 0.05] = 0.0
    hub = int(np.argmax(deg))
    ws[offsets[hub]:offsets[hub + 1]] = 0.0
    return offsets, nbrs, ws


def _jax_tables(offsets, nbrs, ws, seed):
    n = len(offsets) - 1
    nbr_tab = np.full((n + 1, CAP), n, np.int32)
    w_tab = np.zeros((n + 1, CAP), np.float32)
    J._fill_table_rows(CAP, n, np.arange(n, dtype=np.int64),
                       np.diff(offsets), nbrs, ws, seed,
                       out_nbr=nbr_tab[:n], out_w=w_tab[:n])
    return nbr_tab, w_tab, np.cumsum(w_tab, axis=1, dtype=np.float32)


@pytest.mark.parametrize("weighted", [True, False])
def test_from_csr_tables_byte_identical(weighted):
    offsets, nbrs, ws = _csr(1, weighted=weighted)
    assert np.diff(offsets).max() > CAP  # hub rows are exercised
    nbr_j, w_j, cum_j = _jax_tables(offsets, nbrs, ws, seed=7)
    tab = P.DeviceNeighborTable.from_csr(offsets, nbrs, ws, cap=CAP, seed=7,
                                         device="cpu", keep_host=True)
    nbr_p, cum_p = tab.host_tables
    assert nbr_p.tobytes() == nbr_j.tobytes()
    assert cum_p.tobytes() == cum_j.tobytes()
    assert tab.neighbors.numpy().tobytes() == nbr_j.tobytes()
    assert tab.cum_weights.numpy().tobytes() == cum_j.tobytes()
    assert tab.uniform_rows == J._detect_uniform_rows(nbr_j, w_j) \
        == (not weighted)
    assert tab.pad_row == len(offsets) - 1 and tab.cap == CAP


def test_synthetic_graph_matches_engine_tables():
    """The port's arrays + to_csr against the reference's synthetic graph
    built through its native engine and DeviceNeighborTable(graph)."""
    kw = dict(n=300, d=16, num_classes=4, seed=3)
    g_j = jax_synth("t", **kw)
    g_p = synthetic_citation(**kw)
    ids = g_j.engine.all_node_ids()
    np.testing.assert_array_equal(ids, np.arange(300, dtype=np.uint64))
    feats = g_j.engine.get_dense_feature(ids, ["feature"])
    feats = np.concatenate(feats, 1) if isinstance(feats, list) else feats
    assert feats.tobytes() == g_p.features.tobytes()
    labels = g_j.engine.get_dense_feature(ids, "label", 4)
    assert labels.tobytes() == g_p.onehot_labels().tobytes()
    t_j = J.DeviceNeighborTable(g_j.engine, cap=CAP, keep_host=True)
    t_p = P.DeviceNeighborTable.from_csr(g_p.offsets, g_p.neighbors,
                                         cap=CAP, device="cpu",
                                         keep_host=True)
    for a, b in zip(t_j.host_tables, t_p.host_tables):
        assert a.tobytes() == b.tobytes()
    assert t_p.uniform_rows == t_j.uniform_rows is True
    assert (t_p.hub_frac, t_p.edge_keep_frac, t_p.max_degree) == \
        (t_j.hub_frac, t_j.edge_keep_frac, t_j.max_degree)


def test_to_csr_doubles_and_dedups():
    offsets, nbrs = to_csr(4, np.array([[0, 0, 0, 1, 2], [1, 1, 2, 2, 2]]))
    np.testing.assert_array_equal(offsets, [0, 2, 4, 7, 7])
    np.testing.assert_array_equal(nbrs, [1, 2, 0, 2, 0, 1, 2])


@pytest.mark.parametrize("case", ["weighted", "unit", "interior_pad",
                                  "two_weights"])
def test_detect_uniform_rows_agrees(case):
    offsets, nbrs, ws = _csr(2, weighted=case == "weighted")
    nbr_tab, w_tab, cum = _jax_tables(offsets, nbrs, ws, seed=0)
    if case == "interior_pad":
        row = int(np.argmax((nbr_tab[:-1] != nbr_tab.shape[0] - 1).sum(1)))
        nbr_tab[row, 0], w_tab[row, 0] = nbr_tab.shape[0] - 1, 0.0
    if case == "two_weights":
        w_tab[0, 0] = 2.0
    want = J._detect_uniform_rows(nbr_tab, w_tab)
    assert P._detect_uniform_rows(nbr_tab, w_tab) == want
    assert want == (case == "unit")
    cum = np.cumsum(w_tab, axis=1, dtype=np.float32)
    tab = P.DeviceNeighborTable.from_arrays(nbr_tab, cum, device="cpu")
    assert tab.uniform_rows == want


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("count", [1, 3, 4, 10])
def test_sample_hop_bit_exact_with_replayed_uniforms(uniform, count):
    offsets, nbrs, ws = _csr(3, weighted=not uniform)
    nbr_tab, _, cum = _jax_tables(offsets, nbrs, ws, seed=1)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, nbr_tab.shape[0], 40).astype(np.int32)
    rows[:2] = nbr_tab.shape[0] - 1  # pad rows draw pad
    key = jax.random.key(11)
    want = np.asarray(jax.jit(
        lambda n, c, r, k: J.sample_hop(n, c, r, count, k, uniform=uniform),
        compiler_options=_O0)(nbr_tab, cum, rows, key))
    u = torch.from_numpy(np.array(
        jax.random.uniform(key, (len(rows), count))))
    got = P.sample_hop(torch.from_numpy(nbr_tab), torch.from_numpy(cum),
                       torch.from_numpy(rows), count, uniforms=u,
                       uniform=uniform)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("uniform", [False, True])
def test_sample_fanout_rows_bit_exact(uniform):
    offsets, nbrs, ws = _csr(5, weighted=not uniform)
    nbr_tab, _, cum = _jax_tables(offsets, nbrs, ws, seed=2)
    roots = np.arange(16, dtype=np.int32)
    fanouts = (3, 2)
    key = jax.random.fold_in(jax.random.key(17), 9)
    want = jax.jit(lambda n, c, r, k: J.sample_fanout_rows(
        n, c, r, fanouts, k, uniform=uniform),
        compiler_options=_O0)(nbr_tab, cum, roots, key)
    uniforms, k, n = [], key, len(roots)
    for f in fanouts:
        k, sub = jax.random.split(k)
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (n, f)))))
        n *= f
    got = P.sample_fanout_rows(torch.from_numpy(nbr_tab),
                               torch.from_numpy(cum),
                               torch.from_numpy(roots), fanouts,
                               uniforms=uniforms, uniform=uniform)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_generator_draw_picks_real_neighbors():
    offsets, nbrs, ws = _csr(6, weighted=True)
    tab = P.DeviceNeighborTable.from_csr(offsets, nbrs, ws, cap=CAP,
                                         device="cpu", keep_host=True)
    rows = torch.arange(tab.pad_row + 1, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    out = P.sample_hop(tab.neighbors, tab.cum_weights, rows, 5,
                       generator=g).view(-1, 5)
    nbr_h, cum_h = tab.host_tables
    for r in range(tab.pad_row + 1):
        live = set(nbr_h[r][np.diff(cum_h[r], prepend=0) > 0]) \
            or {tab.pad_row}
        assert set(out[r].tolist()) <= live
    again = P.sample_hop(tab.neighbors, tab.cum_weights, rows, 5,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.view(-1, 5), out)


def test_unported_layouts_raise():
    """Row-sharded tables build (without a mesh they are the replicated
    ones, as the reference's put_row_sharded(x, None) places them; on a
    mesh, tests/test_torch_parallel.py); the fused and alias layouts
    build (their own tests: tests/test_torch_alias.py); alias with
    fused, and alias with row sharding, raise the reference's
    ValueError."""
    offsets, nbrs, ws = _csr(7)
    nbr_tab, _, cum = _jax_tables(offsets, nbrs, ws, seed=0)
    sharded = P.DeviceNeighborTable.from_arrays(nbr_tab, cum, device="cpu",
                                                shard_rows=True)
    assert torch.equal(sharded.neighbors, torch.from_numpy(nbr_tab))
    with pytest.raises(ValueError, match="replicated"):
        P.DeviceNeighborTable.from_arrays(nbr_tab, cum, device="cpu",
                                          alias=True, shard_rows=True)
    for kw, key in (({"fused": True}, "nbrcum_table"),
                    ({"alias": True}, "alias_table")):
        tab = P.DeviceNeighborTable.from_arrays(nbr_tab, cum, device="cpu",
                                                **kw)
        assert key in tab.tables
    with pytest.raises(ValueError):
        P.DeviceNeighborTable.from_arrays(nbr_tab, cum, device="cpu",
                                          fused=True, alias=True)
    t, c = torch.from_numpy(nbr_tab), torch.from_numpy(cum)
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        P.sample_hop(t, c, r, 2)  # neither uniforms nor a generator
    with pytest.raises(ValueError):
        P.sample_hop(t, c, r, 2, uniforms=torch.zeros(4, 3))
