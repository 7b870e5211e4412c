"""Training path of the PyTorch port against the JAX package, on the CPU:
DeviceSampledGraphSage trained by BaseEstimator against the reference
estimator's own train step (params converted from the flax init,
uniforms replayed from the reference's key), the nonfinite guard,
evaluate's weighting, keep_best, checkpoint resume, remat, dropout, the
NodeEstimator streams, the cora stand-in and the cora protocol; and
steps_per_loop, the input path with its counters, the feeder and the
profiling hook (the K-step CUDA graph itself is tested on the card in
tests/test_torch_cuda.py)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import json
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.models.graphsage import \
    DeviceSampledGraphSage as JaxDeviceSampledGraphSage
from euler_tpu.parallel.feature_store import \
    DeviceFeatureStore as JaxDeviceFeatureStore
from euler_tpu_torch import obs
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataset import (
    TEST_TYPE, TRAIN_TYPE, VAL_TYPE, engine_from_arrays,
)
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.graph import seed as seed_engine
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.estimator.infer import NodeInferencer
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

N, D, DIM, FANOUTS, CLASSES, B = 300, 16, 16, (3, 2), 4, 8
LR = 0.01

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time (run op by op, a
# flax init compiles each op)
_O0 = {"xla_backend_optimization_level": 0}


def _graph():
    g = synthetic_citation(n=N, d=D, num_classes=CLASSES, seed=2,
                           intra_degree=6.0, inter_degree=2.0)
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, CLASSES), np.float32)])
    return g, feats, labels


_ENGINE = []


def _engine():
    """_graph()'s arrays in the graph engine (built once; node i is id i
    and row i, as in the tables of _tables)."""
    if not _ENGINE:
        _ENGINE.append(engine_from_arrays(_graph()[0]).engine)
    return _ENGINE[0]


class _SerialRoots:
    """The engine graph with sample_node drawn from one numpy stream:
    the same roots whichever thread asks (the engine's stream is per
    thread, so a feeder thread's draws differ from the main thread's)."""

    def __init__(self, graph):
        self._g = graph
        self._rng = np.random.default_rng(0)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._g, name)

    def sample_node(self, count, node_type=-1):
        ids = self._g.all_node_ids()
        if node_type >= 0:
            ids = ids[self._g.get_node_type(ids) == node_type]
        with self._lock:
            return ids[self._rng.integers(0, len(ids), count)]


def _tables(feats, labels, scale_dtype="float32", quantize="int8"):
    g, _, _ = _graph()
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                       device="cpu", keep_host=True)
    store = DeviceFeatureStore.from_arrays(
        feats, labels, quantize=quantize,
        scale_dtype=getattr(torch, scale_dtype), device="cpu")
    return g, tab, store


def _static(tab, store):
    out = {**tab.tables, "feature_table": store.features,
           "label_table": store.labels}
    if store.feature_scale is not None:
        out["feature_scale"] = store.feature_scale
    return out


def _replayed_uniforms(seed):
    """The reference's draw for sample_seed: fold_in(key(17), seed),
    split per hop."""
    key, n, out = jax.random.fold_in(jax.random.key(17), seed), B, []
    for k in FANOUTS:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(sub, (n, k)))))
        n *= k
    return out


def _model(**kw):
    return DeviceSampledGraphSage(CLASSES, D, multilabel=False, dim=DIM,
                                  fanouts=FANOUTS,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)


def _batches(count, seed0=1, replay=True):
    rng = np.random.default_rng(3)
    out = []
    for i in range(count):
        seed = seed0 + i
        b = {"rows": [torch.from_numpy(
            rng.integers(0, N, B).astype(np.int32))], "sample_seed": seed}
        if replay:
            b["sample_uniforms"] = _replayed_uniforms(np.uint32(seed))
        out.append(b)
    return out


def _jax_setup(feats, labels, scale_dtype, tab, quantize="int8"):
    jstore = JaxDeviceFeatureStore.from_arrays(
        feats, labels, quantize=quantize,
        scale_dtype=getattr(jnp, scale_dtype))
    nbr_h, cum_h = tab.host_tables
    static = {"nbr_table": jnp.asarray(nbr_h), "cum_table": jnp.asarray(cum_h),
              "feature_table": jstore.features, "label_table": jstore.labels}
    if jstore.feature_scale is not None:
        static["feature_scale"] = jstore.feature_scale
    jm = JaxDeviceSampledGraphSage(num_classes=CLASSES, multilabel=False,
                                   dim=DIM, fanouts=FANOUTS)
    est = JaxBaseEstimator(jm, {"optimizer": "adam", "learning_rate": LR})
    return est, static


def _init_state(jest, batch):
    """jest._init_state(batch) with the init jitted."""
    variables = dict(jax.jit(jest.model.init, compiler_options=_O0)(
        jax.random.key(0), batch))
    params = variables.pop("params")
    jest.state = JaxTrainState.create(
        apply_fn=jest.model.apply, params=params, tx=jest.tx,
        extra_vars=variables, skipped_steps=jnp.zeros((), jnp.int32))


def _train_step(jest):
    """jest._build_train_step(), compiled at _O0."""
    return jax.jit(jest._make_one_step(), donate_argnums=(0,),
                   compiler_options=_O0)


def _jbatch(b, static):
    return {"rows": [jnp.asarray(b["rows"][0].numpy())],
            "sample_seed": np.uint32(b["sample_seed"]), **static}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _on_bf16_grid(feats):
    """Features q·2^-5 with integer |q| <= 127 and 127 in every column:
    quantize_int8's scale is exactly 2^-5, so every dequantized row and
    every neighbor mean of this test is exact in bfloat16 and the
    kernel's order (one rounding after an f32 sum) and the reference's
    (a rounding per dequantized row) give the same values."""
    q = np.rint(feats / np.abs(feats).max(0) * 127)
    return (q * 2.0 ** -5).astype(np.float32)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_the_reference_estimator(scale_dtype):
    """Params after each of 3 Adam steps against the reference's
    _build_train_step on the same batches: within 1e-5 of the largest
    param with a float32 scale, 2^-7 of it with the bf16 scale.

    bf16 features are put on a grid that bf16 holds exactly: Adam moves
    a parameter by about lr whatever the size of its gradient, so where
    a gradient is at the level of one bf16 rounding, the two rounding
    orders (bounded by test_torch_graphsage) can give the update
    opposite signs — 0.02 apart at lr 0.01, past any rounding
    tolerance. On the grid the rounding orders agree and the comparison
    sees the training path itself."""
    _, feats, labels = _graph()
    if scale_dtype == "bfloat16":
        feats = _on_bf16_grid(feats)
    _, tab, store = _tables(feats, labels, scale_dtype)
    jest, jstatic = _jax_setup(feats, labels, scale_dtype, tab)
    batches = _batches(3)
    _init_state(jest, _jbatch(batches[0], jstatic))
    step_fn = _train_step(jest)
    model = _model()
    model.load_state_dict(flax_to_state_dict(jest.state.params))
    est = BaseEstimator(model, {"optimizer": "adam", "learning_rate": LR,
                                "checkpoint_steps": 0}, device="cpu")
    est.static_batch = _static(tab, store)
    rel = 1e-5 if scale_dtype == "float32" else 2 ** -7
    for i, b in enumerate(batches):
        jest.state, jloss, _ = step_fn(jest.state, _jbatch(b, jstatic))
        res = est.train(iter([b]), max_steps=i + 1)
        want = _leaves(jest.state.params)
        got = _leaves(state_dict_to_flax(est.model.state_dict()))
        tol = rel * max(np.abs(w).max() for w in want)
        for w, g_ in zip(want, got):
            np.testing.assert_allclose(g_, w, rtol=0, atol=tol)
        assert abs(res["loss"] - float(jloss)) <= rel * 10
    assert est.step == int(jest.state.step) == 3


def test_nonfinite_guard_skips_the_update_in_both_packages():
    """A NaN in the feature table: params and optimizer state unchanged,
    the step advances, skipped_steps == 1 — in the reference and here."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels, quantize=None)
    bad = feats.copy()
    bad[:, 0] = np.nan
    _, _, bad_store = _tables(bad, labels, quantize=None)
    jest, jstatic = _jax_setup(feats, labels, "float32", tab, quantize=None)
    _, jbad = _jax_setup(bad, labels, "float32", tab, quantize=None)
    good_b, bad_b = _batches(2)
    _init_state(jest, _jbatch(good_b, jstatic))
    step_fn = _train_step(jest)
    jest.state, _, _ = step_fn(jest.state, _jbatch(good_b, jstatic))
    before = jax.device_get((jest.state.params, jest.state.opt_state))
    jest.state, jloss, _ = step_fn(jest.state, _jbatch(bad_b, jbad))
    after = jax.device_get((jest.state.params, jest.state.opt_state))
    assert not np.isfinite(float(jloss))
    for a, b in zip(_leaves(before), _leaves(after)):
        np.testing.assert_array_equal(a, b)
    assert int(jest.state.step) == 2 and int(jest.state.skipped_steps) == 1

    model = _model()
    model.load_state_dict(flax_to_state_dict(
        jax.device_get(before[0])))
    est = BaseEstimator(model, {"checkpoint_steps": 0}, device="cpu")
    good = {**good_b, **_static(tab, store)}
    est.train(iter([good]), max_steps=1)
    params = {k: v.clone() for k, v in est.model.state_dict().items()}
    opt_state = {k: {n: t.clone() for n, t in s.items()}
                 for k, s in est.optimizer.state_dict()["state"].items()}
    res = est.train(iter([{**bad_b, **_static(tab, bad_store)}]),
                    max_steps=2)
    assert not np.isfinite(res["losses"][0])
    assert res["skipped_steps"] == 1 and est.step == 2
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, s in est.optimizer.state_dict()["state"].items():
        for n, t in s.items():
            assert torch.equal(t, opt_state[k][n]), (k, n)


def _node_estimator(model=None, batch_size=32, graph=None, **params):
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    return NodeEstimator(model or _model(),
                         {"batch_size": batch_size, "checkpoint_steps": 0,
                          **params},
                         graph or _engine(), None, feature_store=store,
                         device_sampler=tab, device="cpu")


def test_evaluate_weights_batches_like_the_reference():
    """evaluate's mean over a padded sweep equals the reference's
    evaluate over the same per-batch (loss, metric, mask)."""
    est = _node_estimator()
    batches = list(est.eval_sweep_input_fn())
    assert float(batches[-1]["metric_mask"].sum()) < est.batch_size
    got = est.evaluate(iter(batches), steps=100)
    raw = []
    for b in batches:
        out = est.run_eval(b)
        raw.append({"loss": np.float32(out.loss), "metric":
                    np.float32(out.metric),
                    "metric_mask": b["metric_mask"]})

    class _Ref:  # the reference's evaluate over precomputed batch outputs
        state, max_id, static_batch = object(), 0, {}

        @staticmethod
        def _eval_step(state, batch):
            return batch["loss"], batch["metric"], None

    want = JaxBaseEstimator.evaluate(_Ref, iter(raw), steps=100)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["metric"] == pytest.approx(want["metric"], rel=1e-6)


def test_keep_best_restores_the_best_snapshot():
    est = _node_estimator(batch_size=8)
    scripted = iter([0.2, 0.9, 0.4, 0.1, -1.0])
    snaps = []

    def fake_evaluate(input_fn, steps=100):
        snaps.append({k: v.clone() for k, v in
                      est.model.state_dict().items()})
        return {"loss": 0.0, "metric": next(scripted)}

    est.evaluate = fake_evaluate
    res = est.train_and_evaluate(est.train_input_fn, None, max_steps=8,
                                 eval_every=2, keep_best=True)
    assert res["best_step"] == 4 and res["train_global_step"] == 8
    final = snaps[-1]  # taken by the final evaluate, after the restore
    for k, v in snaps[1].items():
        assert torch.equal(final[k], v), k
    assert not all(torch.equal(snaps[3][k], v) for k, v in snaps[1].items())


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """3 steps, save, a new estimator (other init) restores and takes
    step 4: the same params and optimizer state as 4 uninterrupted steps,
    dropout on (its draws follow the restored step)."""
    g, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    batches = [{**b, **_static(tab, store)} for b in _batches(4, replay=False)]
    cfg = {"checkpoint_steps": 0, "learning_rate": LR}
    whole = BaseEstimator(_model(dropout=0.5), cfg, device="cpu")
    whole.train(iter(batches), max_steps=4)
    first = BaseEstimator(_model(dropout=0.5),
                          {**cfg, "checkpoint_steps": 3},
                          model_dir=str(tmp_path), device="cpu")
    first.train(iter(batches[:3]), max_steps=3)
    other = DeviceSampledGraphSage(
        CLASSES, D, multilabel=False, dim=DIM, fanouts=FANOUTS, dropout=0.5,
        generator=torch.Generator().manual_seed(9))
    resumed = BaseEstimator(other, {**cfg, "checkpoint_steps": 0},
                            model_dir=str(tmp_path), device="cpu")
    res = resumed.train(iter(batches[3:]), max_steps=4)
    assert res["global_step"] == 4 and resumed.step == 4
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    sa = whole.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    for k in sa:
        for n in sa[k]:
            assert torch.equal(sa[k][n], sb[k][n]), (k, n)


def test_checkpoints_keep_the_last_three(tmp_path):
    est = _node_estimator(batch_size=8, checkpoint_steps=1)
    est.model_dir = str(tmp_path)
    est.train(est.train_input_fn, max_steps=5)
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["ckpt-3.pt", "ckpt-4.pt", "ckpt-5.pt"]
    again = _node_estimator(batch_size=8)
    again.model_dir = str(tmp_path)
    assert again.restore_checkpoint() == 5 and again.step == 5


def test_remat_gives_the_same_loss_and_gradients(monkeypatch):
    """remat=True: the same loss and gradients, and the neighbor mean
    (gather_mean on the card) runs twice: again in the backward pass."""
    from euler_tpu_torch.models import graphsage
    from euler_tpu_torch.ops.gather_mean import gather_mean_reference

    g, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    batch = {**_batches(1)[0], **_static(tab, store)}
    forward = graphsage._GatherEncode.forward
    calls = []

    def counted(self, table, scale, rows):
        def spy(*a):
            calls.append(1)
            return gather_mean_reference(*a)
        return forward(self, table, scale, rows, neighbor_mean=spy)

    monkeypatch.setattr(graphsage._GatherEncode, "forward", counted)
    runs = []
    for remat in (False, True):
        m = _model(remat=remat)
        calls.clear()
        out = m(batch)
        out.loss.backward()
        runs.append((out.loss.detach(), {n: p.grad.clone() for n, p in
                                         m.named_parameters()}, len(calls)))
    (la, ga, ca), (lb, gb, cb) = runs
    assert (ca, cb) == (1, 2)  # remat encodes again in the backward pass
    assert torch.equal(la, lb)
    big = max(float(g.abs().max()) for g in ga.values())
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=0, atol=1e-5 * big)


def test_dropout_zero_is_identity_and_eval_is_deterministic():
    g, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    batch = {**_batches(1)[0], **_static(tab, store)}
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    plain = _model().eval()
    want = plain(batch).embedding
    assert torch.equal(_model().train()(
        {**batch, "dropout_generator": gen()}).embedding, want)
    drop = _model(dropout=0.6)
    assert torch.equal(drop.eval()(batch).embedding, want)
    assert torch.equal(drop(batch).embedding, want)
    drop.train()
    a = drop({**batch, "dropout_generator": gen()}).embedding
    b = drop({**batch, "dropout_generator": gen()}).embedding
    assert torch.equal(a, b)  # the generator fixes the mask
    live = want != 0  # relu zeros stay zero either way
    kept = (a != 0) & live
    assert 0.25 < float(kept.sum() / live.sum()) < 0.55  # keep p = 0.4
    torch.testing.assert_close(a[kept], want[kept] / 0.4)
    assert not a[live & ~kept].any()
    with pytest.raises(ValueError, match="dropout_generator"):
        drop(batch)


@pytest.mark.parametrize("seeds", [(0, 1), (16, 3)])
def test_dropout_stream_follows_the_seed_and_not_the_sampler(seeds):
    """Two estimator seeds draw different masks at the same step, and no
    mask repeats a step's or the previous step's sampling draw (train
    step s samples with seed s + 1). Seed 16 makes seed + 1 the sampler's
    key 17. torch's CPU generator keeps only a seed's low 32 bits, so
    both streams are seeded from a hash of their words."""
    from euler_tpu_torch.models.graphsage import sample_seed_generator

    cpu = torch.device("cpu")
    ests = [BaseEstimator(_model(dropout=0.5),
                          {"seed": s, "checkpoint_steps": 0}, device="cpu")
            for s in seeds]

    def draw(g):
        return torch.rand((B, DIM), generator=g)

    for step in range(4):
        masks = [draw(e._dropout_generator(step)) for e in ests]
        assert not torch.equal(masks[0], masks[1])
        assert torch.equal(masks[0], draw(ests[0]._dropout_generator(step)))
        assert not torch.equal(masks[0],
                               draw(ests[0]._dropout_generator(step + 1)))
        for m in masks:
            for sample_seed in (step, step + 1):
                assert not torch.equal(
                    m, draw(sample_seed_generator(sample_seed, cpu)))


def test_no_dropout_generator_without_dropout(monkeypatch):
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    est = BaseEstimator(_model(), {"checkpoint_steps": 0}, device="cpu")
    est.static_batch = _static(tab, store)

    def refuse(step):
        raise AssertionError("a dropout generator for a model without "
                             "dropout")

    monkeypatch.setattr(est, "_dropout_generator", refuse)
    assert est.train(iter(_batches(2)), max_steps=2)["global_step"] == 2


def test_embed_all_runs_a_train_mode_model_in_eval_mode():
    g, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    m = _model(dropout=0.6).train()
    inf = NodeInferencer(m, store, tab, batch_size=64)
    sweep = list(inf.infer_input_fn())
    ids_a, emb_a = inf.embed_all(sweep)
    ids_b, emb_b = inf.embed_all(sweep)
    assert m.training
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(emb_a, emb_b)


def test_node_estimator_streams_and_splits():
    """Train sample seeds do not depend on how often eval draws; roots
    come from the engine's sample_node over the split (the same roots
    under the same engine seed); sweeps cover a split once with
    stream-1 seeds."""
    est_a = _node_estimator(batch_size=8)
    est_b = _node_estimator(batch_size=8)
    ta, tb, eb = est_a.train_input_fn(), est_b.train_input_fn(), \
        est_b.eval_input_fn()
    train_ids = set(est_a.split_ids(TRAIN_TYPE).tolist())
    for i in range(3):
        seed_engine(10 + i)
        a = next(ta)
        next(eb)
        seed_engine(10 + i)
        b = next(tb)
        assert a["sample_seed"] == b["sample_seed"] < (1 << 31)
        np.testing.assert_array_equal(a["infer_ids"], b["infer_ids"])
        assert set(a["infer_ids"].tolist()) <= train_ids
    g, _, _ = _graph()
    val = est_a.split_ids(VAL_TYPE)
    np.testing.assert_array_equal(val, np.flatnonzero(g.val_mask))
    sweep = list(est_a.eval_sweep_input_fn())
    assert len(sweep) == est_a.eval_sweep_steps()
    assert all(b["sample_seed"] >> 31 == 1 for b in sweep)
    seen = np.concatenate([b["infer_ids"][b["metric_mask"] > 0]
                           for b in sweep])
    np.testing.assert_array_equal(seen, val)
    assert len(est_a.split_ids(-1)) == N


def test_estimators_need_cuda_by_default_and_refuse_unported(monkeypatch):
    for cfg in ({"table_partition": 2}, {"hub_cache_frac": 0.1}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            BaseEstimator(_model(), cfg, device="cpu")
    for cfg in ({"table_partition": 1}, {"hub_cache_frac": 0.0},
                {"max_id": 0}, {"max_id": 100}):  # what the port does
        BaseEstimator(_model(), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BaseEstimator(_model(), {})
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NodeEstimator(_model(), {}, _engine(), None, feature_store=store,
                      device_sampler=tab)


def test_cora_copy_is_pinned_to_the_reference():
    from euler_tpu.dataset import get_dataset as jax_get_dataset
    from euler_tpu_torch.dataset import dataset_arrays

    ref = jax_get_dataset("cora")
    got = dataset_arrays("cora")
    eng = ref.engine
    ids = eng.all_node_ids()
    np.testing.assert_array_equal(ids, np.arange(got.num_nodes))
    np.testing.assert_array_equal(
        eng.get_dense_feature(ids, ["feature"])[0], got.features)
    np.testing.assert_array_equal(
        eng.get_dense_feature(ids, "label", ref.num_classes),
        got.onehot_labels())
    np.testing.assert_array_equal(eng.get_node_type(ids), got.node_types)
    assert sorted(set(got.node_types.tolist())) == \
        [TRAIN_TYPE, VAL_TYPE, TEST_TYPE]
    off, nbr, _, _ = eng.get_full_neighbor(ids, sorted_by_id=True)
    np.testing.assert_array_equal(np.asarray(off, np.int64), got.offsets)
    np.testing.assert_array_equal(np.asarray(nbr, np.int64),
                                  got.neighbors.astype(np.int64))


def test_cora_protocol_on_cpu_reaches_the_floor():
    """The cora stand-in through the port's runner (fit_citation, int8
    features, dropout 0.6) on the CPU: a floor that catches broken
    training, not the quality gate (that runs on the card, 600 steps);
    100 steps keep it to a few seconds."""
    from euler_tpu_torch.examples import run_graphsage

    res = run_graphsage.main(["--device_sampler", "--int8_features",
                              "--device", "cpu", "--max_steps", "100"])
    assert res["train_skipped_steps"] == 0
    assert res["test_metric"] >= 0.77


# -- steps_per_loop, the input path, the feeder, profiling -----------------

def _cpu_estimator(model, tab, store, **cfg):
    est = BaseEstimator(model, {"learning_rate": LR, "checkpoint_steps": 0,
                                "log_steps": 1000, **cfg},
                        device="cpu", model_dir=cfg.pop("model_dir", None))
    est.static_batch = _static(tab, store)
    return est


def test_k_steps_per_loop_match_single_steps():
    """K = 4 over 10 steps (two windows and a tail of 2) against K = 1 on
    the same batches, dropout on: the same global_step, bit-identical
    parameters and optimizer state, the same per-step losses; metric
    (the step-weighted mean of the window nan-means) within float32
    rounding of the plain mean. As tests/test_dataflow_estimator.py
    holds the reference's lax.scan loop."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    batches = _batches(10, replay=False)
    runs = []
    for k in (1, 4):
        est = _cpu_estimator(_model(dropout=0.5), tab, store,
                             steps_per_loop=k)
        runs.append((est, est.train(iter(batches), max_steps=10)))
    (e1, r1), (e4, r4) = runs
    assert r1["global_step"] == r4["global_step"] == e4.step == 10
    assert r4["losses"] == r1["losses"] and r4["loss"] == r1["loss"]
    assert r4["metric"] == pytest.approx(r1["metric"], rel=1e-6)
    for k, v in e1.model.state_dict().items():
        assert torch.equal(e4.model.state_dict()[k], v), k
    s1, s4 = (e.optimizer.state_dict()["state"] for e in (e1, e4))
    for k in s1:
        for n in s1[k]:
            assert torch.equal(s1[k][n], s4[k][n]), (k, n)


def test_k_steps_per_loop_match_the_reference_estimator(tmp_path, capsys):
    """K = 4, log_steps = 6, checkpoint_steps = 6 over 10 steps, the port
    (replayed uniforms) against the reference's BaseEstimator (its
    lax.scan windows and single-step tail): params within 1e-5 of the
    largest (test_three_train_steps_match_the_reference_estimator's
    float32 tolerance), the same step count, loss and metric, the same
    log steps with the same window values, checkpoints at the same
    steps (8, where the second window crosses 6, and 10 at the end)."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    jest, jstatic = _jax_setup(feats, labels, "float32", tab)
    cfg = {"steps_per_loop": 4, "log_steps": 6, "checkpoint_steps": 6}
    jest.steps_per_loop, jest.log_steps, jest.ckpt_steps = 4, 6, 6
    jest.static_batch = jstatic
    saved = []
    jest.save_checkpoint = saved.append
    batches = _batches(10)
    jbatches = [{"rows": [jnp.asarray(b["rows"][0].numpy())],
                 "sample_seed": np.uint32(b["sample_seed"])}
                for b in batches]
    _init_state(jest, _jbatch(batches[0], jstatic))
    model = _model()
    model.load_state_dict(flax_to_state_dict(jest.state.params))
    jres = jest.train(iter(jbatches), max_steps=10)
    jlog = capsys.readouterr().out
    est = _cpu_estimator(model, tab, store, model_dir=str(tmp_path), **cfg)
    res = est.train(iter(batches), max_steps=10)
    log = capsys.readouterr().out
    want = _leaves(jest.state.params)
    got = _leaves(state_dict_to_flax(est.model.state_dict()))
    tol = 1e-5 * max(np.abs(w).max() for w in want)
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_, w, rtol=0, atol=tol)
    assert res["global_step"] == jres["global_step"] == 10
    assert abs(res["loss"] - jres["loss"]) <= 1e-4
    assert abs(res["metric"] - jres["metric"]) <= 1e-4
    parse = [[(int(s), float(l_), float(m)) for s, l_, m in re.findall(
        r"step (\d+): loss=([\d.nan-]+) metric=([\d.nan-]+)", out)]
        for out in (jlog, log)]
    assert [x[0] for x in parse[0]] == [x[0] for x in parse[1]] == [8]
    np.testing.assert_allclose(parse[1][0][1:], parse[0][0][1:], atol=2e-4)
    assert saved == [8, 10]
    assert [s for s, _ in est._checkpoints()] == [8, 10]


def _scripted_input(schedule, make_batch):
    """input_fn over a shared schedule: an int yields that batch,
    "conn" raises ConnectionError, "value" ValueError. A recreated
    iterator goes on where the schedule stands."""
    pos = [0]

    def input_fn():
        def gen():
            while pos[0] < len(schedule):
                ev = schedule[pos[0]]
                pos[0] += 1
                if ev == "conn":
                    raise ConnectionError("connection reset by peer")
                if ev == "value":
                    raise ValueError("bad batch")
                yield make_batch(ev)
        return gen()

    return input_fn


@pytest.mark.parametrize("case", ["defaults", "budget"])
def test_input_path_matches_the_reference(tmp_path, case):
    """One scripted input_fn through both packages. defaults: one
    ConnectionError is retried (input_retries 3, backoff 0.1 s, the
    reference's defaults). budget: input_retries 1, skip_batch_budget 1:
    a retried error, a skipped batch, then a ValueError that writes an
    emergency checkpoint and re-raises. Same input_health and health()
    in both."""
    if case == "defaults":
        schedule, cfg, steps = [0, "conn", 1], {}, 2
    else:
        schedule = [0, "conn", 1, "conn", "conn", 2, "value", 3]
        cfg, steps = {"input_retries": 1, "input_backoff_s": 0.001,
                      "skip_batch_budget": 1}, 5
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    batches = _batches(4, replay=False)
    jest, jstatic = _jax_setup(feats, labels, "float32", tab)
    jest = JaxBaseEstimator(jest.model, {"checkpoint_steps": 0, **cfg},
                            model_dir=str(tmp_path / "jax"))
    jest.static_batch = jstatic
    _init_state(jest, _jbatch(batches[0], jstatic))
    est = _cpu_estimator(_model(), tab, store, model_dir=str(tmp_path / "pt"),
                         **cfg)
    results = []
    for e, conv in ((jest, lambda i: {k: v for k, v in _jbatch(
            batches[i], {}).items()}), (est, lambda i: batches[i])):
        fn = _scripted_input(schedule, conv)
        if case == "defaults":
            res = e.train(fn, max_steps=steps)
            results.append((res["global_step"], res["skipped_batches"]))
        else:
            with pytest.raises(ValueError, match="bad batch"):
                e.train(fn, max_steps=steps)
        results.append((e.input_health, e.health()))
    assert results[0] == results[1] if case == "budget" else \
        results[:2] == results[2:]
    health = results[-1][1]
    if case == "defaults":
        assert results[0] == (2, 0)
        assert health == {"input_failures": 1, "input_retries": 1,
                          "skipped_batches": 0,
                          "emergency_checkpoint_step": None,
                          "last_input_error": "connection reset by peer",
                          "skipped_steps": 0}
    else:
        assert health == {"input_failures": 4, "input_retries": 2,
                          "skipped_batches": 1,
                          "emergency_checkpoint_step": 3,
                          "last_input_error": "bad batch",
                          "skipped_steps": 0}
        assert [s for s, _ in est._checkpoints()] == [3]
    snap = obs.snapshot()["estimator_input_failures_total"]["values"]
    assert snap[f"estimator={est._obs_name}"] == health["input_failures"]


def test_first_batch_error_writes_no_emergency_checkpoint(tmp_path):
    """A fresh estimator with a model_dir whose input_fn raises
    ValueError at its first next(): the error re-raises and nothing is
    saved, since nothing was trained or restored (the reference saves
    nothing while its state is None). The same files on disk (none) and
    the same input_health in both packages."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    jest, jstatic = _jax_setup(feats, labels, "float32", tab)
    jest = JaxBaseEstimator(jest.model, {"checkpoint_steps": 0},
                            model_dir=str(tmp_path / "jax"))
    jest.static_batch = jstatic
    est = _cpu_estimator(_model(), tab, store, model_dir=str(tmp_path / "pt"))
    seen = []
    for e, d in ((jest, tmp_path / "jax"), (est, tmp_path / "pt")):
        with pytest.raises(ValueError, match="bad batch"):
            e.train(_scripted_input(["value"], None), max_steps=2)
        seen.append((sorted(str(p.relative_to(d)) for p in d.rglob("*"))
                     if d.exists() else [], e.input_health))
    assert seen[0] == seen[1]
    assert seen[1] == ([], {"input_failures": 1, "input_retries": 0,
                            "skipped_batches": 0,
                            "emergency_checkpoint_step": None,
                            "last_input_error": "bad batch"})


@pytest.mark.parametrize("steps_per_loop", [1, 4])
def test_feeder_workers_give_the_same_batches_and_results(steps_per_loop):
    """feeder_workers = 2 in device-sampler mode (no batch factory: the
    feeder serialises next() on train_input_fn, its threads move the
    batches to the device): the same losses, parameters and steps as no
    feeder, and the feeder's threads end with train()."""
    runs = []
    for workers in (0, 2):
        est = _node_estimator(batch_size=8, feeder_workers=workers,
                              steps_per_loop=steps_per_loop, log_steps=1000,
                              graph=_SerialRoots(_engine()))
        assert est._train_batch_factory() is None
        before = threading.active_count()
        res = est.train(est.train_input_fn, max_steps=6)
        assert est._live_feeder is None
        assert threading.active_count() <= before
        runs.append((res, est))
    (ra, ea), (rb, eb) = runs
    assert ra["losses"] == rb["losses"] and ra["global_step"] == 6
    for k, v in ea.model.state_dict().items():
        assert torch.equal(eb.model.state_dict()[k], v), k
    snap = obs.snapshot()["feeder_batches_total"]["values"]
    assert snap[f"feeder={eb._obs_name}_train"] >= 6


def test_feeder_spans_train_and_evaluate_segments():
    """train_and_evaluate with feeder_workers = 2: one feeder feeds every
    segment (train() neither wraps nor closes it) and is closed at the
    end; the same parameters as without a feeder."""
    states = []
    for workers in (0, 2):
        est = _node_estimator(batch_size=8, feeder_workers=workers,
                              graph=_SerialRoots(_engine()))
        made = []
        wrap = est._wrap_feeder
        est._wrap_feeder = lambda *a: made.append(wrap(*a)) or made[-1]
        res = est.train_and_evaluate(est.train_input_fn,
                                     est.eval_sweep_input_fn, max_steps=6,
                                     eval_steps=2, eval_every=2)
        assert res["train_global_step"] == 6 and est._live_feeder is None
        assert len(made) == (1 if workers else 0)
        states.append(est.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(states[1][k], v), k


def test_profiling_writes_a_trace_under_model_dir(tmp_path):
    """profiling=True with a model_dir: torch.profiler traces the train
    call into model_dir/prof/ (the reference: jax.profiler.start_trace
    of model_dir/prof)."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    est = _cpu_estimator(_model(), tab, store, profiling=True,
                         model_dir=str(tmp_path))
    est.train(iter(_batches(2, replay=False)), max_steps=2)
    traces = list((tmp_path / "prof").iterdir())
    assert [p.name for p in traces] == ["trace-0-2.json"]
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]


def test_phase_spans_and_histograms_follow_the_reference_names():
    """The loop's obs spans and histograms: train_step → input_wait /
    device_step / hook, one device_step observation per step with
    K = 1 and per window or tail step with K > 1."""
    _, feats, labels = _graph()
    _, tab, store = _tables(feats, labels)
    obs.clear_trace()
    for k, steps, dispatches in ((1, 6, 6), (4, 10, 4)):
        est = _cpu_estimator(_model(), tab, store, steps_per_loop=k,
                             log_steps=5, checkpoint_steps=0)
        est.train(iter(_batches(steps, replay=False)), max_steps=steps)
        hist = obs.snapshot()["estimator_device_step_ms"]["values"]
        assert hist[f"estimator={est._obs_name}"]["count"] == dispatches
        assert obs.snapshot()["estimator_global_step"]["values"][
            f"estimator={est._obs_name}"] == steps
    names = {s.name for s in obs.default_tracer().spans()}
    assert {"train_step", "input_wait", "device_step", "hook"} <= names
