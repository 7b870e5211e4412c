"""The port's multi-device layer (euler_tpu_torch/parallel: mesh,
placement, make_table_gather, the SPMD step, the sharded device-sampled
models, the activation cache on a mesh, sharded states, the dry run)
on 4 gloo ranks on the CPU, against the reference on a 4-device
submesh ({'data': 2, 'model': 2}) of the 8 host devices that
tests/conftest.py sets up.

One gloo job runs every case (tests/torch_dist_worker.py, spawned once
by a module fixture); each test compares one case. Tolerances:
gathers byte-identical (float32 and int8 + scale); the SPMD step's
losses and parameters after 3 Adam steps within 1e-4 relative of the
reference's (the all-reduce adds in another order); the shard gradient
within 1e-5; sharded against one-process within the port: the draws'
picks bit for bit (the reference requires it of itself), losses,
embeddings and caches within 1e-5 relative; the estimators on a data
axis of 2 against one process: losses, metrics and evaluate() within
1e-5, parameters after 3 Adam steps within 1e-4.
"""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import inspect
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
DATA, MODEL = 2, 2


def _mesh4():
    return Mesh(np.asarray(jax.devices()[:4]).reshape(DATA, MODEL),
                ("data", "model"))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _ref_model():
    from euler_tpu.models import ShardedSupervisedGraphSage

    c = W.SPMD
    return ShardedSupervisedGraphSage(
        num_classes=c["num_classes"], multilabel=False, dim=c["dim"],
        fanouts=c["fanouts"], max_id=c["max_id"], id_dim=c["id_dim"])


@pytest.fixture(scope="module")
def ref_init():
    """The reference ShardedSupervisedGraphSage's init params (unboxed
    numpy tree)."""
    from flax.core import meta

    m = _ref_model()
    b0 = W.spmd_batches(1)[0]
    v = jax.jit(m.init, compiler_options=_O0)(jax.random.key(0), b0)
    return jax.tree_util.tree_map(np.asarray, meta.unbox(v)["params"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_init):
    out = str(tmp_path_factory.mktemp("gloo_parallel"))
    np.savez(os.path.join(out, "inputs.npz"), **dict(_flat(ref_init)))
    return W.run_job("parallel", out)


def _coords(r):
    return r // MODEL, r % MODEL


def _data_slice(x, d):
    n = x.shape[0] // DATA
    return x[d * n:(d + 1) * n]


def test_mesh_shape_and_coordinates(ranks):
    for r, out in enumerate(ranks):
        d, m = _coords(r)
        assert out["mesh_a"].tolist() == [DATA, MODEL, d, m]


@pytest.mark.parametrize("case", ["f32", "f32_2d", "int32"])
def test_sharded_gather_matches_the_reference(ranks, case):
    """make_table_gather over a row-sharded table equals the reference's
    masked take + psum on its 4-device mesh, byte for byte."""
    from euler_tpu.parallel import make_table_gather, put_row_sharded

    tab, rows, itab, _, _ = W.gather_inputs()
    mesh = _mesh4()
    t = itab if case == "int32" else tab
    r = rows.reshape(2, -1) if case == "f32_2d" else rows
    want = np.asarray(jax.jit(make_table_gather(mesh), compiler_options=_O0)(
        put_row_sharded(t, mesh), jnp.asarray(r)))
    for rk, out in enumerate(ranks):
        d, m = _coords(rk)
        assert out["gather/shard"].tolist() == [m * 11, 11, 22]
        got = out[f"gather/{case}"]
        exp = _data_slice(want.reshape(16, *want.shape[len(r.shape):]), d)
        assert got.reshape(exp.shape).tobytes() == exp.tobytes()


def test_sharded_int8_gather_dequantizes_as_the_reference(ranks):
    from euler_tpu.models.graphsage import gather_feature_rows
    from euler_tpu.parallel import make_table_gather
    from euler_tpu.parallel.feature_store import quantize_int8
    from euler_tpu.parallel.placement import put_row_sharded

    _, _, _, feats, qrows = W.gather_inputs()
    q, scale = quantize_int8(feats)
    mesh = _mesh4()
    g = make_table_gather(mesh)
    want = np.asarray(jax.jit(
        lambda t, s, r: gather_feature_rows(
            {"feature_table": t, "feature_scale": s}, [r], gather=g)[0],
        compiler_options=_O0)(put_row_sharded(q, mesh), jnp.asarray(scale),
                              jnp.asarray(qrows)))
    for rk, out in enumerate(ranks):
        d, _ = _coords(rk)
        assert out["gather/int8_deq"].tobytes() == \
            _data_slice(want, d).tobytes()
        assert out["gather/int8_raw"].tobytes() == \
            _data_slice(q[qrows], d).tobytes()


def test_gather_rejects_an_unpadded_table(ranks):
    assert all(int(o["gather/unpadded_refused"]) == 1 for o in ranks)


def _ref_spmd(params):
    """3 Adam steps of the reference's make_spmd_train_step on its
    {'data': 2, 'model': 2} mesh from the given params."""
    import optax

    from euler_tpu.parallel import make_spmd_train_step, shard_batch

    mesh = _mesh4()
    m = _ref_model()
    tx = optax.adam(W.SPMD["lr"])
    placed = {k: dict(v) for k, v in params.items()}
    rep = NamedSharding(mesh, P())
    placed = jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), placed)
    placed["id_emb"]["table"] = jax.device_put(
        params["id_emb"]["table"], NamedSharding(mesh, P("model", None)))
    state = {"params": placed, "opt_state": tx.init(placed),
             "extra_vars": {}, "step": jnp.zeros((), jnp.int32),
             "skipped_steps": jnp.zeros((), jnp.int32)}
    step = make_spmd_train_step(m, tx)
    losses = []
    with mesh:
        for b in W.steps_batches():
            state, loss, _ = step(state, shard_batch(b, mesh))
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state["params"])


def _port_init_as_flax(out):
    from euler_tpu_torch.convert import state_dict_to_flax

    sd = {k[len("spmd/init/"):]: torch.from_numpy(v)
          for k, v in out.items() if k.startswith("spmd/init/")}
    return state_dict_to_flax(sd)


def test_spmd_step_matches_the_reference(ranks):
    """ShardedSupervisedGraphSage through spmd_init + make_spmd_train_step
    on {'data': 2, 'model': 2}: the losses and the parameters after 3
    Adam steps within 1e-4 of the reference's SPMD step from the same
    parameters."""
    from euler_tpu_torch.convert import state_dict_to_flax

    init = _port_init_as_flax(ranks[0])
    want_losses, want = _ref_spmd(init)
    got = state_dict_to_flax({k[len("spmd/final/"):]: torch.from_numpy(v)
                              for k, v in ranks[0].items()
                              if k.startswith("spmd/final/")})
    for out in ranks:
        np.testing.assert_allclose(out["spmd/losses"], want_losses,
                                   rtol=1e-4)
    assert want_losses[-1] < want_losses[0]
    for (k, a), (k2, b) in zip(sorted(_flat(got)), sorted(_flat(want))):
        assert k == k2
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=k)


def test_shard_gradient_is_the_references_global_slice(ranks):
    """The id table shard's gradient (after the SUM over 'data') equals
    the rows of the reference's gradient of the global loss: it would be
    2x too large if the model-axis sum all-reduced in its backward."""
    init = _port_init_as_flax(ranks[0])
    m = _ref_model()
    b0 = W.spmd_batches(1)[0]
    g = jax.jit(jax.grad(lambda p: m.apply({"params": p}, b0).loss),
                compiler_options=_O0)(init)
    table = np.asarray(g["id_emb"]["table"])
    kernel = np.asarray(g["out"]["kernel"])
    per = table.shape[0] // MODEL
    for rk, out in enumerate(ranks):
        _, mi = _coords(rk)
        assert out["spmd/shard_rows"] == per
        np.testing.assert_allclose(out["spmd/grad_table"],
                                   table[mi * per:(mi + 1) * per],
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(out["spmd/grad_out_w"], kernel.T,
                                   rtol=1e-5, atol=1e-8)


def test_replicas_are_bit_equal_after_three_steps(ranks):
    """Every replicated parameter and its Adam moments are equal bit for
    bit on the 4 ranks; the id table's shards on the ranks of one model
    index likewise."""
    keys = [k for k in ranks[0] if k.startswith("spmd/local")]
    assert any("exp_avg_sq" in k for k in keys)
    for k in keys:
        sharded = "id_emb.table" in k
        for rk, out in enumerate(ranks[1:], 1):
            twin = ranks[rk % MODEL] if sharded else ranks[0]
            assert out[k].tobytes() == twin[k].tobytes(), k


def test_nan_on_one_rank_skips_the_step_on_every_rank(ranks):
    for out in ranks:
        assert int(out["nan/skipped"]) == 1
        assert int(out["nan/unchanged"]) == 1


def test_reference_state_shards_in_and_gathers_out(ranks, ref_init):
    """The reference's ShardedSupervisedGraphSage params go into a 4-rank
    job (each rank its rows) and come back whole; a 4-rank checkpoint
    restores in one process: the same tree, the same loss."""
    from euler_tpu_torch.convert import (
        flax_to_state_dict, state_dict_to_flax,
    )

    table = ref_init["id_emb"]["table"]
    per = table.shape[0] // MODEL
    m = _ref_model()
    b0 = W.spmd_batches(1)[0]
    want_loss = float(jax.jit(lambda p: m.apply({"params": p}, b0).loss,
                              compiler_options=_O0)(ref_init))
    for rk, out in enumerate(ranks):
        _, mi = _coords(rk)
        assert out["convert/in_shard"].tobytes() == \
            table[mi * per:(mi + 1) * per].tobytes()
        np.testing.assert_allclose(out["convert/in_loss"], want_loss,
                                   rtol=1e-5)
    whole = {k[len("convert/out/"):]: torch.from_numpy(v)
             for k, v in ranks[0].items() if k.startswith("convert/out/")}
    for k, v in flax_to_state_dict(ref_init).items():
        assert whole[k].numpy().tobytes() == v.numpy().tobytes(), k
    # the 4-rank state in one process: the reference's tree, the loss
    tree = state_dict_to_flax(whole)
    assert sorted(k for k, _ in _flat(tree)) == \
        sorted(k for k, _ in _flat(ref_init))
    one = W._spmd_model()
    one.load_state_dict(whole)
    one.eval()
    with torch.no_grad():
        b = {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
             else torch.from_numpy(v) for k, v in b0.items()}
        np.testing.assert_allclose(float(one(b).loss), want_loss, rtol=1e-5)


def test_sharded_sage_promotes_bf16_features_as_the_reference(ref_init):
    """bf16 features beside the float32 id embedding: the reference's
    jnp.concatenate promotes them to a float32 input, and so does the
    port (no bf16 rounding of the embedding): the loss and the
    embeddings within 1e-5 relative, in one process."""
    from euler_tpu_torch.convert import flax_to_state_dict

    m = _ref_model()
    b0 = W.spmd_batches(1)[0]
    b16 = {**b0, "layers": [jnp.asarray(x, jnp.bfloat16)
                            for x in b0["layers"]]}
    want_loss, want_emb = jax.jit(
        lambda p: (lambda o: (o.loss, o.embedding))(
            m.apply({"params": p}, b16)), compiler_options=_O0)(ref_init)
    one = W._spmd_model()
    one.load_state_dict(flax_to_state_dict(ref_init))
    one.eval()
    with torch.no_grad():
        got = one({"ids": [torch.from_numpy(x) for x in b0["ids"]],
                   "layers": [torch.from_numpy(x).to(torch.bfloat16)
                              for x in b0["layers"]],
                   "labels": torch.from_numpy(b0["labels"])})
    assert got.embedding.dtype == torch.float32
    np.testing.assert_allclose(float(got.loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(got.embedding.numpy(), np.asarray(want_emb),
                               rtol=1e-5, atol=1e-6)


MODELS = ["split", "fused", "unsup", "walk", "layerwise", "act_cache"]


@pytest.mark.parametrize("name", MODELS)
def test_sharded_model_matches_one_process(ranks, name):
    """Each device-sampled model on {'data': 2, 'model': 2} with its
    tables row-sharded against the port's one-process run: the same
    picks bit for bit (every rank its data slice of the global draw, or
    the whole draw where it is global), the global loss, the embeddings
    and the written cache within 1e-5."""
    for rk, out in enumerate(ranks):
        d, _ = _coords(rk)
        picks = sorted(k for k in out
                       if k.startswith(f"models/{name}/1/pick"))
        assert picks
        for k in picks:
            one = out[k.replace("/1/", "/0/")]
            sh = out[k]
            want = one if name == "layerwise" else _data_slice(one, d)
            assert sh.tobytes() == want.tobytes(), k
        np.testing.assert_allclose(out[f"models/{name}/1/loss"],
                                   out[f"models/{name}/0/loss"], rtol=1e-5)
        emb1 = out[f"models/{name}/0/emb"]
        np.testing.assert_allclose(out[f"models/{name}/1/emb"],
                                   _data_slice(emb1, d), rtol=1e-5,
                                   atol=1e-6)
        # gather_mean only on the one-process path, where the reference's
        # plain mean over a replicated table is; never on a sharded one
        assert int(out[f"models/{name}/1/gather_mean_calls"]) == 0
        assert int(out[f"models/{name}/0/gather_mean_calls"]) == (
            0 if name in ("walk", "layerwise") else
            2 if name == "act_cache" else 1)
        if name == "act_cache":
            np.testing.assert_allclose(out["models/act_cache/1/cache"],
                                       out["models/act_cache/0/cache"],
                                       rtol=1e-5, atol=1e-6)
            assert np.abs(out["models/act_cache/1/cache"]).sum() > 0


def test_sharding_keeps_the_references_refusals(ranks):
    for out in ranks:
        assert int(out["refuse/remat"]) == 1
        assert int(out["refuse/alias"]) == 1


def test_act_cache_row_sharded_through_the_estimator(ranks):
    """The reference's test_act_cache_row_sharded: shard_act_cache
    refuses before the first step, then the cache stays row-sharded
    through NodeEstimator's steps on the mesh, writes land, and
    memory_plan's sharded-cache bytes equal a shard's."""
    for out in ranks:
        assert int(out["est/early_refused"]) == 1
        local, total = out["est/cache_shard"].tolist()
        assert local * MODEL == total
        assert int(out["est/touched"]) > 0
        plan, real = out["est/plan_cache_bytes"].tolist()
        assert plan == real
        assert int(out["est/step"]) == 8
        assert np.isfinite(out["est/losses"]).all()


DATA_AXIS = ["sharded", "sage", "deepwalk"]


@pytest.mark.parametrize("name", DATA_AXIS)
def test_estimator_on_the_data_axis_matches_one_process(ranks, name):
    """NodeEstimator (ShardedSupervisedGraphSage, SupervisedGraphSage)
    and EdgeEstimator (DeepWalk) on {'data': 2, 'model': 2} against the
    same estimator in one process, fed the same global batches (masks
    that count different rows on the two data halves): each step's
    training loss and metric and evaluate()'s within 1e-5 relative (the
    ranks' shares add in another order), the parameters after 3 Adam
    steps within 1e-4 (as the SPMD step against the reference)."""
    for out in ranks:
        np.testing.assert_allclose(out[f"dax/{name}/1/steps"],
                                   out[f"dax/{name}/0/steps"], rtol=1e-5)
        np.testing.assert_allclose(out[f"dax/{name}/1/eval"],
                                   out[f"dax/{name}/0/eval"], rtol=1e-5)
        params = [k for k in out if k.startswith(f"dax/{name}/0/param/")]
        assert params
        for k in params:
            np.testing.assert_allclose(out[k.replace("/0/", "/1/")], out[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_what_does_not_split_refuses_a_data_axis(ranks):
    """GraphEstimator's packed graphs, LINE (not held to its one-process
    run on a data axis) and a batch array of 5 rows on a data axis of 2
    raise ValueError."""
    for out in ranks:
        assert out["dax/refused"].tolist() == [1, 1, 1]


def test_dryrun_runs_its_six_legs_on_four_ranks(ranks):
    for out in ranks:
        legs = {k[len("dryrun/"):]: float(v) for k, v in out.items()
                if k.startswith("dryrun/")}
        assert {"spmd", "cluster", "device_sampled", "layerwise",
                "fused_sharded", "walk", "act_cache"} <= set(legs)
        assert all(np.isfinite(v) for v in legs.values())
        # the fused row-sharded table draws what the split one draws
        assert legs["fused_sharded"] == legs["device_sampled"]
        assert legs["act_cache_rows_written"] > 0
    assert len({float(o["dryrun/spmd"]) for o in ranks}) == 1


def test_mesh_and_process_group_need_a_card_without_cpu(monkeypatch):
    """device=None means CUDA and NCCL: without a card make_mesh and
    initialize_multihost raise, and no gloo group is started in its
    place."""
    import torch.distributed as dist

    from euler_tpu_torch.parallel.mesh import make_mesh
    from euler_tpu_torch.parallel.multihost import initialize_multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, initialize_multihost):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    assert not dist.is_initialized()


def test_multihost_config_reads_both_launchers(monkeypatch):
    from euler_tpu_torch.parallel.multihost import (
        MultihostConfig, process_batch_slice,
    )

    for k in ("EULER_TPU_COORDINATOR", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(KeyError):
        MultihostConfig.from_env()
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert MultihostConfig.from_env() == MultihostConfig(
        "10.0.0.1:29500", 8, 3, 3)
    monkeypatch.setenv("EULER_TPU_COORDINATOR", "10.0.0.2:9999")
    monkeypatch.setenv("EULER_TPU_NUM_HOSTS", "4")
    monkeypatch.setenv("EULER_TPU_HOST_IDX", "1")
    assert MultihostConfig.from_env() == MultihostConfig(
        "10.0.0.2:9999", 4, 1, 3)
    assert process_batch_slice(16) == slice(0, 16)


def test_file_barrier_and_hooks_are_the_references(tmp_path):
    """FileBarrier is a copy of euler_tpu/utils/hooks.py's; sync_exit is
    a no-op in a world of one."""
    import threading

    from euler_tpu.utils import hooks as J
    from euler_tpu_torch.utils import hooks as T

    for name in ("__init__", "_tag", "wait"):
        assert inspect.getsource(getattr(T.FileBarrier, name)) == \
            inspect.getsource(getattr(J.FileBarrier, name)), name
    T.sync_exit()
    done = []
    bars = [T.FileBarrier(str(tmp_path), 3, run_id="t", poll_ms=5)
            for _ in range(3)]
    ts = [threading.Thread(target=lambda i=i: (bars[i].wait(i),
                                               done.append(i)))
          for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert sorted(done) == [0, 1, 2]


def test_shard_act_cache_keeps_the_references_errors():
    """shard_act_cache raises before the estimator's first step, does
    nothing on a trivial model axis or for a model without caches, as
    the reference's does (models/graphsage.py:267-296)."""
    from types import SimpleNamespace

    from euler_tpu_torch.models.graphsage import shard_act_cache

    class TwoWide:  # a model axis of 2, no process group needed
        def size(self, axis):
            return 2

    class OneWide:
        def size(self, axis):
            return 1

    no_cache = SimpleNamespace(encoder=SimpleNamespace(caches=lambda: []))
    with pytest.raises(ValueError, match="train step"):
        shard_act_cache(SimpleNamespace(_restore_pending=True,
                                        model=no_cache), TwoWide())
    shard_act_cache(SimpleNamespace(_restore_pending=True), OneWide())
    shard_act_cache(SimpleNamespace(_restore_pending=False, model=no_cache,
                                    _graphed=None), TwoWide())
    shard_act_cache(SimpleNamespace(_restore_pending=False,
                                    model=SimpleNamespace(), _graphed=None),
                    TwoWide())
