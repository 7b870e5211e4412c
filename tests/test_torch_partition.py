"""The port's row exchanges, sharded embedding and partitioned feature
store (euler_tpu_torch/parallel: ring_exchange, sharded_embedding,
partitioned_store, memory_plan, train's table_store hook) on 4 gloo
ranks on the CPU, against the reference on a 4-device submesh of the
8 host devices (tests/conftest.py): {'data': 1, 'model': 4}, as the
reference's tests/test_partition.py, and {'data': 2, 'model': 2}.

One gloo job runs every case (tests/torch_dist_worker.py, spawned once
by a module fixture); each test compares one case. Tolerances: lookups
and partitioned gathers byte-identical (float32 and int8); the
exchanges' gradients within 1e-6 relative of the reference's (a row's
contributions add in another order); memory_plan exact; the
partitioned estimator's losses within 1e-6 of the replicated store's.
"""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

_O0 = {"xla_backend_optimization_level": 0}
K = 4


def _mesh(shape=(1, 4)):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ("data", "model"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.run_job("partition", str(tmp_path_factory.mktemp("gloo_part")))


def _blocks(x, axis=0):
    return np.split(np.asarray(x), K, axis=axis)


@pytest.mark.parametrize("name", ["ring", "allgather"])
def test_exchange_matches_the_reference(ranks, name):
    """ring_lookup / allgather_lookup: each rank's block of rows equals
    the reference's exchange byte for byte (float32 and int8), and its
    shard's gradient the reference's gradient rows."""
    from euler_tpu.parallel import ring_exchange as R

    fn = getattr(R, f"{name}_lookup")
    table, ids, table8, ids8 = W.ring_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    tsh = NamedSharding(mesh, P("model", None))
    ish = NamedSharding(mesh, P("model"))

    def loss(t):
        return (fn(t, jax.device_put(ids, ish), mesh) ** 2).sum()

    t = jax.device_put(table, tsh)
    want = np.asarray(jax.jit(lambda t: fn(t, jax.device_put(ids, ish),
                                           mesh))(t))
    grad = np.asarray(jax.jit(jax.grad(loss))(t))
    want8 = np.asarray(fn(jax.device_put(table8, tsh),
                          jax.device_put(ids8, ish), mesh))
    assert want8.dtype == np.int8
    for r, out in enumerate(ranks):
        assert out[f"x/{name}/out"].tobytes() == _blocks(want)[r].tobytes()
        np.testing.assert_allclose(out[f"x/{name}/grad"], _blocks(grad)[r],
                                   rtol=1e-6)
        assert out[f"x/{name}/int8"].dtype == np.int8
        assert out[f"x/{name}/int8"].tobytes() == \
            _blocks(want8)[r].tobytes()


def test_pick_lookup_strategy_is_the_references():
    from euler_tpu.parallel.ring_exchange import pick_lookup_strategy as J
    from euler_tpu_torch.parallel.ring_exchange import pick_lookup_strategy

    for args in ((10, 1, 128), (1024, 8, 128, 4), (1 << 20, 8, 128, 4),
                 (1024, 8, 128, 4, 1024), (53, 4, 8, 1)):
        assert pick_lookup_strategy(*args) == J(*args)


@pytest.mark.parametrize("tag,shape", [("m4", (1, 4)), ("m2", (2, 2))])
def test_sharded_embedding_lookups_match_the_reference(ranks, tag, shape):
    """ShardedEmbedding's 'gspmd', 'ring' and 'allgather' lookups agree
    with each other and with the reference's gspmd take: the rows byte
    for byte, the shard gradients within 1e-6."""
    from euler_tpu.parallel import ShardedEmbedding, apply_param_shardings

    ids, table = W.emb_inputs()
    mesh = _mesh(shape)
    m = ShardedEmbedding(num_embeddings=64, dim=8, mesh=mesh)
    v = apply_param_shardings(
        m.init(jax.random.key(0), jnp.asarray(ids)), mesh)
    v = {"params": {"table": jax.device_put(
        table, v["params"]["table"].sharding)}}

    def loss(p):
        return jnp.mean(jnp.sum(m.apply(p, jnp.asarray(ids)) ** 2, -1))

    with mesh:
        out = np.asarray(jax.jit(lambda p: m.apply(p, jnp.asarray(ids)))(v))
        grad = np.asarray(jax.jit(jax.grad(loss))(v)["params"]["table"])
    dp, mp = shape
    per = 64 // mp
    n = len(ids) // dp
    for r, o in enumerate(ranks):
        d, mi = r // mp, r % mp
        for mode in ("gspmd", "ring", "allgather"):
            got = o[f"emb/{tag}/{mode}/out"]
            assert got.tobytes() == out[d * n:(d + 1) * n].tobytes(), mode
            np.testing.assert_allclose(o[f"emb/{tag}/{mode}/grad"],
                                       grad[mi * per:(mi + 1) * per],
                                       rtol=1e-6, atol=1e-9, err_msg=mode)
        assert int(o["emb/guard"]) == 1


def test_row_sparse_table_gradient_is_summed_dense_over_data(ranks):
    """A whole table's row-sparse gradient (utils/layers.Embedding on a
    card, F.embedding(sparse=True) here) on the data axis of {2, 2}:
    reduce_gradients makes it dense and sums it, so every rank holds the
    global loss's gradient of every row, within 1e-6."""
    import torch

    ids, table = W.emb_inputs()
    t = torch.tensor(table, requires_grad=True)
    ((t[torch.from_numpy(ids).long()] ** 2).sum(-1).mean()).backward()
    for o in ranks:
        assert int(o["emb/row_sparse/was_sparse"]) == 1
        np.testing.assert_allclose(o["emb/row_sparse/grad"],
                                   t.grad.numpy(), rtol=1e-6, atol=1e-9)


def _ref_store(feats, degrees, **kw):
    from euler_tpu.parallel import PartitionedFeatureStore as J

    return J.from_arrays(feats, degrees, mesh=_mesh(), **kw)


@pytest.mark.parametrize("strategy", ["allgather", "ring", "psum"])
@pytest.mark.parametrize("hub_frac", [0.0, 0.05])
def test_partitioned_gather_byte_identical_f32(ranks, strategy, hub_frac):
    """make_gather on the port's store equals a take on the reference
    store's permuted table (and the reference's own make_gather) byte
    for byte; the stores' host layouts are the same."""
    from euler_tpu_torch.parallel.partitioned_store import (
        PartitionedFeatureStore,
    )

    feats, degrees = W.skewed()
    ref = _ref_store(feats, degrees, hub_cache_frac=hub_frac)
    rows = np.random.default_rng(7).integers(
        0, ref.pad_row + 1, 53).astype(np.int32)
    want = ref.apply_permutation(feats)[rows]
    if strategy != "psum":
        got_ref = np.asarray(ref.make_gather(strategy)(jnp.asarray(rows)))
        assert got_ref.tobytes() == want.tobytes()
    for out in ranks:
        assert out[f"p/f32/{strategy}/{hub_frac}"].tobytes() == \
            want.tobytes()

    class _OneRankMesh:  # the host arithmetic needs no process group
        shape = {"data": 1, "model": K}
        device = torch.device("cpu")

        def size(self, a):
            return self.shape[a]

        def index(self, a):
            return 0

    port = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=_OneRankMesh(), hub_cache_frac=hub_frac)
    np.testing.assert_array_equal(port.permutation, ref.permutation)
    assert (port.hub_size, port.pad_row, port.per_chip_bytes) == \
        (ref.hub_size, ref.pad_row, ref.per_chip_bytes)
    assert port.route_batch(rows) == ref.route_batch(rows)


@pytest.mark.parametrize("strategy", ["allgather", "ring", "psum"])
def test_partitioned_gather_byte_identical_int8(ranks, strategy):
    from euler_tpu.parallel.feature_store import quantize_int8

    feats, degrees = W.skewed(seed=1)
    ref = _ref_store(feats, degrees, hub_cache_frac=0.05, quantize="int8")
    q, _ = quantize_int8(feats)
    rows = np.random.default_rng(11).integers(
        0, ref.pad_row + 1, 40).astype(np.int32)
    want = ref.apply_permutation(q)[rows]
    for out in ranks:
        got = out[f"p/int8/{strategy}"]
        assert got.dtype == np.int8 and got.tobytes() == want.tobytes()


def test_auto_strategy_picks_and_matches(ranks):
    feats, degrees = W.skewed(seed=2)
    ref = _ref_store(feats, degrees, hub_cache_frac=0.02)
    want = ref.apply_permutation(feats)
    for out in ranks:
        assert out["p/auto"].tobytes() == want.tobytes()


def test_hub_rows_never_in_remote_leg(ranks):
    feats, degrees = W.skewed(seed=3)
    ref = _ref_store(feats, degrees, hub_cache_frac=0.1)
    H = ref.hub_size
    rows = np.random.default_rng(13).integers(
        0, ref.pad_row + 1, 256).astype(np.int32)
    full = ref.apply_permutation(feats)
    for out in ranks:
        cold = out["hub/cold"]
        assert (cold[rows < H] == full.shape[0] - 1).all()
        assert (cold[rows >= H] == rows[rows >= H]).all()
        assert out["hub/out"].tobytes() == full[rows].tobytes()
        r = ref.route_batch(rows)
        assert out["hub/route"].tolist() == [r["rows"], r["cached"],
                                             r["local"], r["remote"]]


def test_hub_mass_counters_and_health(ranks):
    feats, degrees = W.skewed(seed=4)
    ref = _ref_store(feats, degrees, hub_cache_frac=0.1)
    for out in ranks:
        (hits, misses, local, remote, cached, per_chip, hub,
         pad) = out["ctr/stats"].tolist()
        assert (hub, pad, per_chip) == (ref.hub_size, ref.pad_row,
                                        ref.per_chip_bytes)
        assert hits == cached == hub and misses == pad - hub
        assert local + remote == misses
        assert float(out["ctr/hub_mass"]) == pytest.approx(ref.hub_mass)
        assert out["ctr/health"].tolist() == [hub, per_chip]


def test_make_table_gather_hub_cache_both_branches(ranks):
    for out in ranks:
        assert out["mtg/rep"].tobytes() == out["mtg/want"].tobytes()
        assert out["mtg/sharded"].tobytes() == out["mtg/want"].tobytes()


def test_spmd_train_step_table_store_counting(ranks):
    for out in ranks:
        assert int(out["store_step/counted"]) == 2 * 16
        assert np.isfinite(out["store_step/loss"])


def test_train_loop_loss_trajectory_identity(ranks):
    """An SGD loop over partitioned + hub-cached gathers follows the
    replicated loop's losses bit for bit."""
    for out in ranks:
        assert out["traj/part"].tobytes() == out["traj/base"].tobytes()


def test_estimator_trains_on_partitioned_store(ranks):
    """NodeEstimator(mesh, table_partition 4, hub_cache_frac 0.1) over
    the partitioned store follows the replicated store's losses, counts
    every gathered row, and health() reports the store."""
    for out in ranks:
        assert np.isfinite(out["est/part"]).all()
        np.testing.assert_allclose(out["est/part"], out["est/base"],
                                   rtol=1e-6)
        assert int(out["est/counted"]) == 6 * (8 + 24 + 48)
        hub_stat, hub, in_batch = out["est/hub"].tolist()
        assert hub_stat == hub > 0 and in_batch == 1


def test_engine_store_lookup_and_host_overflow(ranks):
    """The engine-built store: lookups gather the engine's features
    (unknown ids zeros); with device_rows the evicted rows come from
    the host tier byte for byte, and lookup() refuses them."""
    g, ids = W._engine_graph()
    probe = np.concatenate([ids[:7], [np.uint64(10_000)]])

    def dense(x):
        f = g.get_dense_feature(x, ["feature"])
        return np.concatenate(f, axis=1) if isinstance(f, list) else f

    for out in ranks:
        np.testing.assert_array_equal(out["eng/lookup"], dense(probe))
        host = out["eng/host_mask"]
        n_host, hits, counted = out["eng/host_counts"].tolist()
        assert n_host == len(ids) - len(ids) // 2 == int(host.sum())
        assert hits >= n_host and counted == 2 * n_host
        assert int(out["eng/refused"]) == 1
        assert out["eng/host_rows"].tobytes() == dense(ids[host]).tobytes()
        assert out["eng/dev_rows"].tobytes() == dense(ids[~host]).tobytes()


def test_cluster_feeds_spmd_training(ranks):
    """The reference's test_cluster_feeds_spmd_training: 2-shard graph
    service batches drive the SPMD step on {'data': 2, 'model': 2}; the
    loss falls over 8 steps, the same on every rank."""
    losses = ranks[0]["cluster/losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for out in ranks[1:]:
        assert out["cluster/losses"].tobytes() == losses.tobytes()


_PLAN_CASES = [
    ("plan_tables", dict(n_nodes=2_450_000, cap=32, feat_dim=100,
                         label_dim=47, mp=mp, fused=fused, quantize=qz,
                         act_cache_dim=acd, act_cache_sharded=acs))
    for mp in (1, 2, 4) for fused in (False, True) for qz in ("int8", None)
    for acd, acs in ((0, False), (64, True))
] + [
    ("plan_partitioned_table", dict(n_nodes=n, feat_dim=d, k_shards=k,
                                    hub_cache_frac=h, quantize=qz,
                                    label_dim=ld, device_rows=dr,
                                    hbm_budget_bytes=b))
    for n, d, k, h, qz, ld, dr, b in (
        (1000, 64, 4, 0.01, "int8", 0, None, None),
        (1000, 64, 4, 0.0, None, 16, None, None),
        (1 << 20, 128, 2, 0.0, None, 0, None, 1 << 20),
        (2_450_000, 100, 4, 0.01, "int8", 47, 2_000_000, None))
]


@pytest.mark.parametrize("fn,kw", _PLAN_CASES)
def test_memory_plan_is_the_references(fn, kw):
    """memory_plan is a copy: every plan equals the reference's, and the
    H100 budget is the one key it adds."""
    from euler_tpu.parallel import memory_plan as J
    from euler_tpu_torch.parallel import memory_plan as T

    assert getattr(T, fn)(**kw) == getattr(J, fn)(**kw)
    assert set(T.HBM_BYTES) - set(J.HBM_BYTES) == {"h100"}
    assert all(T.HBM_BYTES[k] == v for k, v in J.HBM_BYTES.items())
    assert T.plan_partitioned_table(1000, chip="h100")["hbm_budget_bytes"] \
        == 80 << 30
