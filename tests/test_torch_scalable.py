"""DeviceSampledScalableSage (the activation cache, bench.py --act_cache)
of the PyTorch port against the JAX package, on the CPU: three Adam
steps with repeated roots against the reference estimator's own train
step (params and cache converted from the flax init, uniforms replayed
from the reference's key), the cache through evaluate, a skipped step
and a checkpoint, and refresh_act_cache against the reference's."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.models import graphsage as JG
from euler_tpu_torch.convert import (
    flax_to_state_dict, state_dict_to_flax_variables,
)
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.models.graphsage import (
    DeviceSampledScalableSage, refresh_act_cache,
)
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.utils import encoders as PE

N, D, DIM, K, CLASSES, B, LR = 40, 8, 8, 4, 3, 12, 0.01

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time
_O0 = {"xla_backend_optimization_level": 0}


def _data(ring=False):
    """A small citation graph (or a ring where every node's one
    neighbor is the next node, so every draw is determined) with its
    port tables (float32 features) and the reference's static batch."""
    g = synthetic_citation(n=N, d=D, num_classes=CLASSES, seed=5,
                           intra_degree=4.0, inter_degree=1.0)
    offsets, nbrs = g.offsets, g.neighbors
    if ring:
        offsets = np.arange(N + 1, dtype=np.int64)
        nbrs = ((np.arange(N) + 1) % N).astype(np.int32)
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, CLASSES), np.float32)])
    tab = DeviceNeighborTable.from_csr(offsets, nbrs, cap=8, device="cpu",
                                       keep_host=True)
    store = DeviceFeatureStore.from_arrays(feats, labels, device="cpu")
    static = {**tab.tables, "feature_table": store.features,
              "label_table": store.labels}
    nbr_h, cum_h = tab.host_tables
    jstatic = {"nbr_table": jnp.asarray(nbr_h),
               "cum_table": jnp.asarray(cum_h),
               "feature_table": jnp.asarray(feats),
               "label_table": jnp.asarray(labels)}
    return static, jstatic


@pytest.fixture(scope="module")
def data():
    return _data()


def _batches(count):
    """Root batches with repeated roots (each batch draws 12 of 9
    nodes), and the reference's uniforms for each: key(17) folded with
    the sample_seed, one hop, no split."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(count):
        seed = np.uint32(i + 1)
        roots = rng.integers(0, 9, B).astype(np.int32)
        assert len(set(roots.tolist())) < B
        u = jax.random.uniform(jax.random.fold_in(jax.random.key(17), seed),
                               (B, K))
        out.append({"rows": [torch.from_numpy(roots)],
                    "sample_seed": int(seed),
                    "sample_uniforms": [torch.from_numpy(np.array(u))]})
    return out


def _jbatch(b, jstatic):
    return {"rows": [jnp.asarray(b["rows"][0].numpy())],
            "sample_seed": np.uint32(b["sample_seed"]), **jstatic}


def _reference(encoder, jstatic, batch, cache_dtype=None):
    """The reference estimator over the port model's fresh parameters and
    a zero cache, as its _init_state would make them (its own init,
    traced, not run, has the same names, shapes and dtypes)."""
    jm = JG.DeviceSampledScalableSage(
        num_classes=CLASSES, multilabel=False, dim=DIM, fanout=K,
        num_layers=2, max_id=N, encoder=encoder, cache_dtype=cache_dtype)
    jest = JaxBaseEstimator(jm, {"optimizer": "adam", "learning_rate": LR})
    model = DeviceSampledScalableSage(
        CLASSES, D, multilabel=False, dim=DIM, fanout=K, num_layers=2,
        max_id=N, encoder=encoder,
        cache_dtype=None if cache_dtype is None else torch.bfloat16,
        generator=torch.Generator().manual_seed(0))
    variables = state_dict_to_flax_variables(model.state_dict())
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    want = jax.eval_shape(jm.init, jax.random.key(0),
                          _jbatch(batch, jstatic))
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(variables)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    params = variables.pop("params")
    jest.state = JaxTrainState.create(
        apply_fn=jm.apply, params=params, tx=jest.tx,
        extra_vars=variables, skipped_steps=jnp.zeros((), jnp.int32))
    return jest


def _train_step(jest):
    """jest._build_train_step(), compiled at _O0."""
    return jax.jit(jest._make_one_step(), donate_argnums=(0,),
                   compiler_options=_O0)


def _port(encoder, jest, static, cache_dtype=None, **cfg):
    model = DeviceSampledScalableSage(
        CLASSES, D, multilabel=False, dim=DIM, fanout=K, num_layers=2,
        max_id=N, encoder=encoder, cache_dtype=cache_dtype)
    model.load_state_dict(flax_to_state_dict(
        {"params": jest.state.params, **jest.state.extra_vars}))
    est = BaseEstimator(model, {"optimizer": "adam", "learning_rate": LR,
                                "checkpoint_steps": 0, **cfg}, device="cpu")
    est.static_batch = dict(static)
    return est


def _cache(est):
    return state_dict_to_flax_variables(est.model.state_dict())["cache"]


def _close(got, want, rel):
    """Leaf by leaf within rel of the tree's largest value."""
    g = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(got)]
    w = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    tol = rel * max(np.abs(b).max() for b in w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("encoder,cache", [("sage", "float32"),
                                           ("gcn", "float32"),
                                           ("sage", "bfloat16")])
def test_three_steps_match_the_reference(data, encoder, cache):
    """Loss, params and cache after each of 3 Adam steps whose batches
    repeat roots (the last occurrence's write wins, and the next layer
    reads the written rows, its gradient going through them): within
    1e-5 of the largest value with a float32 cache; 2^-7 with a
    bfloat16 cache (one bf16 rounding of a cached row)."""
    static, jstatic = data
    batches = _batches(3)
    jdt = None if cache == "float32" else jnp.bfloat16
    tdt = None if cache == "float32" else torch.bfloat16
    jest = _reference(encoder, jstatic, batches[0], jdt)
    step_fn = _train_step(jest)
    est = _port(encoder, jest, static, tdt)
    rel = 1e-5 if cache == "float32" else 2 ** -7
    for i, b in enumerate(batches):
        jest.state, jloss, _ = step_fn(jest.state, _jbatch(b, jstatic))
        res = est.train(iter([b]), max_steps=i + 1)
        assert abs(res["loss"] - float(jloss)) <= rel * 10
        variables = state_dict_to_flax_variables(est.model.state_dict())
        _close(variables["params"], jest.state.params, rel)
        _close(variables["cache"], jest.state.extra_vars["cache"], rel)
    h = est.model.encoder.cache_1.h
    assert h.dtype == (tdt or torch.float32)
    assert int((h.float().abs().sum(1) > 0).sum()) <= 9


def test_cache_writes_keep_the_last_duplicate():
    """A row written twice in one batch keeps the later value, and every
    duplicate writes it (the write is deterministic)."""
    cache = PE._ScalableCache(9, 2)
    ids = torch.tensor([3, 5, 3, 7, 5, 3], dtype=torch.int32)
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    cache.write(ids, vals)
    torch.testing.assert_close(cache.h[3], vals[5])
    torch.testing.assert_close(cache.h[5], vals[4])
    torch.testing.assert_close(cache.h[7], vals[3])
    assert int((cache.h.abs().sum(1) > 0).sum()) == 3
    rows, old = cache.staged
    assert rows.tolist() == ids.tolist() and not old.any()
    cache.settle(torch.ones(()))  # a skipped step puts the rows back
    assert not cache.h.any() and cache.staged is None


def test_forward_reads_both_neighbor_means_through_one_call_each(data):
    """embed's two neighbor reads go through its neighbor_mean (the
    gather_mean kernel on the card): layer 0 over the feature table,
    layer 1 over the bfloat16 cache with a float32 output; with the
    plain version passed in, the embedding is the default's."""
    from euler_tpu_torch.ops.gather_mean import gather_mean_reference

    static, _ = data
    model = DeviceSampledScalableSage(
        CLASSES, D, multilabel=False, dim=DIM, fanout=K, num_layers=2,
        max_id=N, cache_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0)).eval()
    model.encoder.cache_1.h.normal_(generator=torch.Generator().manual_seed(1))
    calls = []

    def spy(table, rows, scale, out_dtype=None):
        calls.append((table.dtype, tuple(rows.shape), out_dtype))
        return gather_mean_reference(table, rows, scale, out_dtype=out_dtype)

    batch = {**_batches(1)[0], **static}
    with torch.no_grad():
        got = model.embed(batch, neighbor_mean=spy)
        want = model.embed(batch)
    assert calls == [(torch.float32, (B, K), None),
                     (torch.bfloat16, (B, K), torch.float32)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_evaluate_and_a_skipped_step_leave_the_cache(data, tmp_path):
    """evaluate reads the cache and writes nothing; a step with a NaN
    loss is skipped and puts its cache writes back, as the reference
    keeps its old extra_vars; a checkpoint round trip restores the cache
    with the params."""
    static, jstatic = data
    batches = _batches(3)
    jest = _reference("sage", jstatic, batches[0])
    est = _port("sage", jest, static, model_dir=None)
    est.train(iter(batches[:1]), max_steps=1)
    before = {k: v.clone() for k, v in est.model.state_dict().items()}
    ev = est.evaluate(iter(batches[1:]), steps=2)
    assert np.isfinite(ev["loss"])
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    bad = dict(static, feature_table=static["feature_table"].clone())
    bad["feature_table"][:, 0] = float("nan")
    est.static_batch = bad
    res = est.train(iter(batches[1:2]), max_steps=2)
    assert res["skipped_steps"] == 1 and est.step == 2
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    est.static_batch = dict(static)
    ckpt = _port("sage", jest, static, checkpoint_steps=1,
                 model_dir=None)
    ckpt.model_dir = str(tmp_path)
    ckpt.train(iter(batches[:2]), max_steps=2)
    saved = {k: v.clone() for k, v in ckpt.model.state_dict().items()}
    other = _port("sage", jest, static)
    other.model_dir = str(tmp_path)
    assert other.restore_checkpoint() == 2
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert other.model.encoder.cache_1.h.abs().sum() > 0


@pytest.mark.parametrize("encoder", ["sage", "gcn"])
def test_refresh_act_cache_matches_the_reference(encoder):
    """On a ring (one neighbor a node, so both packages draw the same
    rows whatever their uniforms), after one train step: every live row
    written, the tail chunk's clamp, the pad row zero again, within 1e-5
    of the reference's refresh."""
    static, jstatic = _data(ring=True)
    batches = _batches(1)
    jest = _reference(encoder, jstatic, batches[0])
    est = _port(encoder, jest, static)
    jest.state, _, _ = _train_step(jest)(jest.state,
                                         _jbatch(batches[0], jstatic))
    est.train(iter(batches), max_steps=1)
    _close(_cache(est), jest.state.extra_vars["cache"], 1e-5)

    class _Ref:  # the reference's refresh reads state and static_batch
        pass

    ref = _Ref()
    ref.state, ref.static_batch = jest.state, {
        **jstatic, "feature_table": jstatic["feature_table"]}
    JG.refresh_act_cache(ref, chunk=16)
    refresh_act_cache(est, chunk=16)
    want = ref.state.extra_vars["cache"]
    _close(_cache(est), want, 1e-5)
    h = est.model.encoder.cache_1.h
    assert not h[N].any()
    assert int((h[:N].abs().sum(1) > 0).sum()) >= N - 3


def test_specs_and_export_params_are_the_references(data):
    """export_spec of the new models and configurations: the reference
    model's class name and scalar dataclass fields, as its export_bundle
    records them (a bfloat16 cache_dtype is no scalar and is left out);
    and the params export_bundle writes (convert.flax_param_paths) are
    the reference's param tree's paths, without the cache collection."""
    import dataclasses

    from euler_tpu_torch.convert import flax_param_paths
    from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage

    def ref_spec(m):
        spec = {"model_class": type(m).__name__}
        for f in dataclasses.fields(m):
            v = getattr(m, f.name, None)
            if f.name not in ("parent", "name") and (
                    isinstance(v, (str, int, float, bool)) or v is None):
                spec[f.name] = v
        return spec

    kw = dict(num_classes=CLASSES, multilabel=False, dim=DIM, fanout=K,
              num_layers=2, max_id=N, store_decay=0.8)
    cases = [
        (DeviceSampledScalableSage(CLASSES, D, multilabel=False, dim=DIM,
                                   fanout=K, num_layers=2, max_id=N,
                                   store_decay=0.8),
         JG.DeviceSampledScalableSage(**kw)),
        (DeviceSampledScalableSage(CLASSES, D, multilabel=False, dim=DIM,
                                   fanout=K, num_layers=2, max_id=N,
                                   store_decay=0.8, encoder="gcn",
                                   cache_dtype=torch.bfloat16,
                                   uniform_sampling=True),
         JG.DeviceSampledScalableSage(**kw, encoder="gcn",
                                      cache_dtype=jnp.bfloat16,
                                      uniform_sampling=True)),
        (DeviceSampledGraphSage(CLASSES, D, multilabel=False, dim=DIM,
                                fanouts=(3, 2), encoder="genie",
                                aggregator="maxpool"),
         JG.DeviceSampledGraphSage(num_classes=CLASSES, multilabel=False,
                                   dim=DIM, fanouts=(3, 2),
                                   encoder="genie", aggregator="maxpool")),
    ]
    static, jstatic = data
    batch = _jbatch(_batches(1)[0], jstatic)
    for port, ref in cases:
        assert port.export_spec() == ref_spec(ref)
        want = jax.eval_shape(ref.init, jax.random.key(0), batch)["params"]
        paths = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
        got = {k: v.shape for k, v in
               flax_param_paths(port.state_dict()).items()}
        assert got == paths
