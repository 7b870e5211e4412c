"""The alias and fused neighbor-table layouts of the PyTorch port against
the JAX package (euler_tpu/parallel/device_sampler.py,
device_walk.py), on the CPU: tables byte-identical from the same arrays,
picks bit-exact with the uniforms JAX draws replayed, the layouts'
rejections the reference's."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import numpy as np
import pytest
import torch

from euler_tpu.parallel import device_sampler as J
from euler_tpu.parallel import device_walk as JW
from euler_tpu_torch.parallel import device_sampler as P
from euler_tpu_torch.parallel import device_walk as PW

CAP = 8

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time
_O0 = {"xla_backend_optimization_level": 0}


def _tables(seed=0, n=300, weighted=True):
    """[N+1, CAP] split tables from a random CSR with hubs above CAP,
    zero-degree rows, zero-weight edges and one dead hub (all weights
    0), plus one row with an interior pad slot and one dead row that
    keeps its neighbor ids. Returns (nbr, slot weights, cum)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 3 * CAP, n)
    deg[:5] = 0
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, offsets[-1]).astype(np.int32)
    ws = np.ones(len(nbrs), np.float32)
    if weighted:
        ws = rng.uniform(0.1, 5.0, len(nbrs)).astype(np.float32)
        ws[rng.random(len(nbrs)) < 0.05] = 0.0
        hub = int(np.argmax(deg))
        ws[offsets[hub]:offsets[hub + 1]] = 0.0
    nbr_tab = np.full((n + 1, CAP), n, np.int32)
    w_tab = np.zeros((n + 1, CAP), np.float32)
    J._fill_table_rows(CAP, n, np.arange(n, dtype=np.int64), deg, nbrs, ws,
                       seed, out_nbr=nbr_tab[:n], out_w=w_tab[:n])
    full = int(np.flatnonzero((nbr_tab[:n] != n).sum(1) == CAP)[0])
    nbr_tab[full, 2], w_tab[full, 2] = n, 0.0      # an interior pad
    dead = int(np.flatnonzero((nbr_tab[:n] != n).sum(1) >= 2)[-1])
    w_tab[dead] = 0.0                              # ids kept, weight 0
    return nbr_tab, w_tab, np.cumsum(w_tab, axis=1, dtype=np.float32)


@pytest.fixture(scope="module")
def weighted():
    return _tables(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("source", ["weights", "cum", "chunked_cum",
                                    "from_csr"])
def test_alias_tables_byte_identical(weighted, source, monkeypatch):
    """build_alias_tables' words for hubs, zero-degree rows, dead rows,
    an interior pad and the pad row; from_arrays(alias=True) rebuilds
    them from the cum rows in chunks of any size; from_csr builds them
    from the exact slot weights, as the reference's table does."""
    nbr, w, cum = weighted
    want = J.build_alias_tables(nbr, w_tab=w)
    if source == "weights":
        got = P.build_alias_tables(nbr, w_tab=w)
    elif source == "cum":
        want = J.build_alias_tables(nbr, cum_tab=cum)
        got = P.build_alias_tables(nbr, cum_tab=cum)
    elif source == "chunked_cum":
        want = J.build_alias_tables(nbr, cum_tab=cum)
        monkeypatch.setattr(P, "_CHUNK_ROWS", 7)
        monkeypatch.setattr(P, "_ALIAS_CHUNK_ROWS", 5)
        monkeypatch.setattr(P.build_alias_tables, "__defaults__",
                            (None, None, 5))
        tab = P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu",
                                                alias=True)
        assert set(tab.tables) == {"nbr_table", "cum_table", "alias_table"}
        got = tab.alias_table.numpy()
    else:
        rng = np.random.default_rng(2)
        deg = rng.integers(0, 3 * CAP, 200)
        offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        nbrs = rng.integers(0, 200, offsets[-1]).astype(np.int32)
        ws = rng.uniform(0.0, 2.0, len(nbrs)).astype(np.float32)
        tab = P.DeviceNeighborTable.from_csr(offsets, nbrs, ws, cap=CAP,
                                             seed=3, device="cpu",
                                             alias=True)
        n_tab = np.full((201, CAP), 200, np.int32)
        w_tab = np.zeros((201, CAP), np.float32)
        J._fill_table_rows(CAP, 200, np.arange(200, dtype=np.int64), deg,
                           nbrs, ws, 3, out_nbr=n_tab[:200],
                           out_w=w_tab[:200])
        want = J.build_alias_tables(n_tab, w_tab=w_tab)
        got = tab.alias_table.numpy()
    assert got.dtype == np.int32 and got.tobytes() == want.tobytes()
    assert (want[-1] == -1).all() and (want == -1).any(1).sum() > 5


def test_table_fill_in_row_chunks_matches_one_pass(monkeypatch):
    """The port fills a table's rows in chunks on a thread pool; with
    chunks of 7 rows (hubs, zero-degree rows, zero-weight edges and a
    dead hub among them) its tables equal the reference's one pass over
    all rows byte for byte."""
    rng = np.random.default_rng(5)
    n = 90
    deg = rng.integers(0, 3 * CAP, n)
    deg[:4] = 0
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, offsets[-1]).astype(np.int32)
    ws = rng.uniform(0.0, 3.0, len(nbrs)).astype(np.float32)
    ws[rng.random(len(nbrs)) < 0.1] = 0.0
    hub = int(np.argmax(deg))
    ws[offsets[hub]:offsets[hub + 1]] = 0.0
    want_nbr = np.full((n + 1, CAP), n, np.int32)
    want_w = np.zeros((n + 1, CAP), np.float32)
    J._fill_table_rows(CAP, n, np.arange(n, dtype=np.int64), deg, nbrs, ws,
                       3, out_nbr=want_nbr[:n], out_w=want_w[:n])
    monkeypatch.setattr(P, "_FILL_CHUNK_ROWS", 7)
    tab = P.DeviceNeighborTable.from_csr(offsets, nbrs, ws, cap=CAP, seed=3,
                                         device="cpu", keep_host=True)
    got_nbr, got_cum = tab.host_tables
    assert got_nbr.tobytes() == want_nbr.tobytes()
    assert got_cum.tobytes() == np.cumsum(want_w, axis=1,
                                          dtype=np.float32).tobytes()


def _alias_uniforms(key, n, count):
    return np.array(jax.random.uniform(key, (2, n, count)))


@pytest.mark.parametrize("count", [1, 4])
def test_alias_picks_bit_exact_with_replayed_uniforms(weighted, count):
    """The flat pick (count < 4) and the row pick (count >= 4)."""
    nbr, w, cum = weighted
    alias = J.build_alias_tables(nbr, w_tab=w)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, nbr.shape[0], 60).astype(np.int32)
    rows[:2] = nbr.shape[0] - 1
    key = jax.random.key(11)
    want = np.asarray(jax.jit(
        lambda n, c, r, k, a: J.sample_hop(n, c, r, count, k,
                                           alias_table=a),
        compiler_options=_O0)(nbr, cum, rows, key, alias))
    got = P.sample_hop(_t(nbr), _t(cum), _t(rows), count,
                       uniforms=_t(_alias_uniforms(key, len(rows), count)),
                       alias_table=_t(alias))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_alias_on_unit_weights_picks_as_the_uniform_draw():
    """On unit-weight front-packed rows every alias word keeps its own
    column (P = 1), so the alias pick equals the uniform draw's pick for
    the same first uniform."""
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 2 * CAP, 200)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    tab = P.DeviceNeighborTable.from_csr(
        offsets, rng.integers(0, 200, offsets[-1]).astype(np.int32),
        cap=CAP, device="cpu", keep_host=True)
    assert tab.uniform_rows
    nbr, cum = tab.host_tables
    n = tab.pad_row
    alias = P.build_alias_tables(nbr, cum_tab=cum)
    rows = _t(np.arange(n + 1, dtype=np.int32))
    u = torch.rand((2, n + 1, 5), generator=torch.Generator().manual_seed(0))
    a = P.sample_hop(_t(nbr), _t(cum), rows, 5, uniforms=u,
                     alias_table=_t(alias))
    b = P.sample_hop(_t(nbr), _t(cum), rows, 5, uniforms=u[0], uniform=True)
    assert torch.equal(a, b)


def test_fused_table_and_picks_match(weighted):
    """fuse_tables_host byte for byte; the fused draw's picks equal the
    split weighted draw's for the same uniforms, and the reference's
    fused draw's, hop by hop through sample_fanout_rows_fused."""
    nbr, _, cum = weighted
    fused = P.fuse_tables_host(nbr, cum)
    assert fused.tobytes() == J.fuse_tables_host(nbr, cum).tobytes()
    tab = P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu",
                                            fused=True)
    assert set(tab.tables) == {"nbrcum_table"}
    assert tab.neighbors is None and tab.cum_weights is None
    assert tab.fused_table.numpy().tobytes() == fused.tobytes()
    roots = np.arange(0, 300, 13, dtype=np.int32)
    fanouts = (4, 2)
    key = jax.random.fold_in(jax.random.key(17), 5)
    want = jax.jit(lambda f, r, k: J.sample_fanout_rows_fused(
        f, r, fanouts, k), compiler_options=_O0)(fused, roots, key)
    uniforms, k, n = [], key, len(roots)
    for f in fanouts:
        k, sub = jax.random.split(k)
        uniforms.append(_t(jax.random.uniform(sub, (n, f))))
        n *= f
    got = P.sample_fanout_rows_fused(tab.fused_table, _t(roots), fanouts,
                                     uniforms=uniforms)
    split = P.sample_fanout_rows(_t(nbr), _t(cum), _t(roots), fanouts,
                                 uniforms=uniforms)
    for a, b, c in zip(got, split, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        assert torch.equal(a, b)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0)])
def test_walk_rows_alias_bit_exact(weighted, p, q):
    """walk_rows(alias_table=...): the p = q = 1 steps take the alias
    draw ([2, B] uniforms a step), node2vec's biased steps ignore it."""
    nbr, w, cum = weighted
    if p != 1.0:  # unit slots: float32 sums them exactly in any order
        n = nbr.shape[0] - 1
        cum = np.cumsum(np.where(nbr != n, 1.0, 0.0), axis=1,
                        dtype=np.float32)
        w = np.diff(cum, axis=1, prepend=0).astype(np.float32)
    alias = J.build_alias_tables(nbr, w_tab=w)
    roots = np.arange(5, 300, 7, dtype=np.int32)
    key = jax.random.key(3)
    want = np.asarray(jax.jit(lambda n, c, r, k, a: JW.walk_rows(
        n, c, r, 4, k, p=p, q=q, alias_table=a),
        compiler_options=_O0)(nbr, cum, roots, key, alias))
    uniforms, k = [], key
    for i in range(4):
        k, sub = jax.random.split(k)
        alias_step = i == 0 or (p == 1.0 and q == 1.0)
        shape = (2, len(roots), 1) if alias_step else (len(roots),)
        uniforms.append(_t(jax.random.uniform(sub, shape)).reshape(
            -1, len(roots)).squeeze(0))
    got = PW.walk_rows(_t(nbr), _t(cum), _t(roots), 4, uniforms=uniforms,
                       p=p, q=q, alias_table=_t(alias))
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_rejections_are_the_references(weighted):
    nbr, w, cum = weighted
    with pytest.raises(ValueError, match="split"):
        P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu",
                                          alias=True, fused=True)
    with pytest.raises(ValueError, match="replicated"):
        P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu",
                                          alias=True, shard_rows=True)
    # without a mesh, shard_rows places replicated tables, as the
    # reference's put_row_sharded(x, None) does
    plain = P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu")
    rows = P.DeviceNeighborTable.from_arrays(nbr, cum, device="cpu",
                                             shard_rows=True)
    for k, t in plain.tables.items():
        assert torch.equal(rows.tables[k], t)
    alias = _t(P.build_alias_tables(nbr, w_tab=w))
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="exclusive"):
        P.sample_hop(_t(nbr), _t(cum), r, 2, uniforms=torch.zeros(2, 4, 2),
                     uniform=True, alias_table=alias)
    with pytest.raises(ValueError, match=r"\[2, 4, 2\]"):
        P.sample_hop(_t(nbr), _t(cum), r, 2, uniforms=torch.zeros(4, 2),
                     alias_table=alias)
    with pytest.raises(ValueError, match="exactly one"):
        P.build_alias_tables(nbr)
    with pytest.raises(ValueError, match="255"):
        P.build_alias_tables(np.zeros((3, 256), np.int32),
                             w_tab=np.ones((3, 256), np.float32))
