"""The layerwise (FastGCN/LADIES) family of the port against the JAX
package, on the CPU: LayerwiseDataFlow / FastGCNDataFlow in both modes,
sample_layerwise_rows (split and alias) under replayed uniforms,
LayerEncoder, DeviceSampledLayerwiseGCN in a NodeEstimator (one step's
loss and gradients, then Adam steps), NodeEstimator's eval_via_flow, and
run_fastgcn in both modes.

Inputs are made with numpy from a seed; both packages read
byte-identical engines (tests/test_torch_engine.py), so under one engine
seed their host batches are the same arrays. The replayed uniforms are
the reference's: a layer's `jax.random.uniform` from its split key (and
the alias pick's from the next split). Weights are small integers, whose
float32 sums are exact in any order, so the port's cumulative sums equal
XLA's and the picks are bit-exact (ROADMAP "Sampling"). Tolerances
(float32): adjacencies 1e-6 (a row's normalizing sum adds in another
order); forward outputs, losses and gradients rtol 1e-5 (atol 1e-6);
parameters after Adam steps atol 1e-3 of the learning rate, as the
other estimator parity tests state it (Adam moves a parameter by about
lr whatever its gradient's size). The reference's programs are jitted
at XLA's lowest backend optimization level."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FastGCNDataFlow as JFastGCNDataFlow
from euler_tpu.dataflow import LayerwiseDataFlow as JLayerwiseDataFlow
from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth
from euler_tpu.estimator import NodeEstimator as JNodeEstimator
from euler_tpu.estimator.base_estimator import TrainState as JTrainState
from euler_tpu.estimator.base_estimator import _merged, _to_device_tree
from euler_tpu.graph import seed as j_seed
from euler_tpu.models import DeviceSampledLayerwiseGCN as JLayerwiseGCN
from euler_tpu.parallel import DeviceFeatureStore as JDeviceFeatureStore
from euler_tpu.parallel import DeviceNeighborTable as JDeviceNeighborTable
from euler_tpu.parallel import device_layerwise as JL
from euler_tpu.parallel import device_sampler as JS
from euler_tpu.utils.encoders import LayerEncoder as JLayerEncoder
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataflow import FastGCNDataFlow, LayerwiseDataFlow
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import _to_device
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.estimator.graphed_loop import GraphedLoop
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.models.graphsage import DeviceSampledLayerwiseGCN
from euler_tpu_torch.parallel.device_layerwise import sample_layerwise_rows
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.utils.encoders import LayerEncoder

_O0 = {"xla_backend_optimization_level": 0}
N, D, C, DIM, B, LR = 200, 8, 3, 6, 12, 0.01
SIZES = (16, 24)
CAP = 8
CPU = torch.device("cpu")
KW = dict(n=N, d=D, num_classes=C, seed=5)


@pytest.fixture(scope="module")
def engines():
    """The citation stand-in in both engines (byte-identical graphs)."""
    return engine_from_arrays(synthetic_citation(**KW)).engine, \
        jsynth("t", **KW).engine


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _close_trees(got, want, rtol=1e-5, atol=1e-6):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g_, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w),
                                   rtol=rtol, atol=atol)


# -- the host flows -----------------------------------------------------------

@pytest.mark.parametrize("flow", ["layerwise", "closure", "fastgcn"])
def test_layerwise_flows_match_the_reference(engines, flow):
    """LayerwiseDataFlow with sampled pools, with exact closures
    (sample=False), and FastGCNDataFlow, over the same engine graph
    after the same engine seed: levels, adjacencies and features equal
    (exact)."""
    pg, jg = engines
    out = []
    for g, seed_fn, lw, fg in ((pg, p_seed, LayerwiseDataFlow,
                                FastGCNDataFlow),
                               (jg, j_seed, JLayerwiseDataFlow,
                                JFastGCNDataFlow)):
        seed_fn(3)
        roots = g.sample_node(B, 0)
        cls = fg if flow == "fastgcn" else lw
        f = cls(g, list(SIZES), sample=flow != "closure",
                feature_ids=["feature"])
        out.append(f(roots))
    got, want = out
    assert sorted(got) == sorted(want) == ["adjs", "ids", "layers"]
    for k in want:
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            _same(a, b)
    if flow != "closure":
        assert [len(x) for x in got["ids"]] == [B, B + SIZES[0],
                                                B + sum(SIZES)]


# -- the device draw ----------------------------------------------------------

def _tables(seed=0, n=120):
    """[n+1, CAP] split tables from a random CSR with small integer
    weights (sums exact in any order), hubs above CAP, zero-weight edges
    and isolated nodes 0-9; the alias table from the slot weights."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 3 * CAP, n)
    deg[:10] = 0
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, offsets[-1]).astype(np.int32)
    ws = rng.integers(0, 5, len(nbrs)).astype(np.float32)
    nbr = np.full((n + 1, CAP), n, np.int32)
    w = np.zeros((n + 1, CAP), np.float32)
    JS._fill_table_rows(CAP, n, np.arange(n, dtype=np.int64), deg, nbrs, ws,
                        seed, out_nbr=nbr[:n], out_w=w[:n])
    return nbr, np.cumsum(w, axis=1, dtype=np.float32), \
        JS.build_alias_tables(nbr, w_tab=w)


def _replayed(key, sizes, alias: bool):
    """The reference's per-layer uniforms from `key` (split per layer;
    with the alias table, split again for the pick's [2, m, 1]) as the
    port's [m] / [3, m] tensors."""
    out = []
    for m in sizes:
        key, kg = jax.random.split(key)
        u = np.asarray(jax.random.uniform(kg, (m,)))
        if alias:
            key, ka = jax.random.split(key)
            ua = np.asarray(jax.random.uniform(ka, (2, m, 1)))
            u = np.stack([u, ua[0, :, 0], ua[1, :, 0]])
        out.append(torch.from_numpy(np.array(u)))
    return out


@pytest.mark.parametrize("layout", ["split", "alias"])
@pytest.mark.parametrize("roots", ["mixed", "dead"])
def test_sample_layerwise_rows_matches_the_reference(layout, roots):
    """The pools, level by level, equal under replayed uniforms and the
    adjacencies within 1e-6: "mixed" roots include isolated nodes (their
    rows keep only the self-loop), "dead" roots are all isolated, so the
    whole frontier is dead (total 0): the split draw's searchsorted runs
    past every zero slot to the clamp on the last slot, the alias draw
    resolves every draw to the pad row."""
    nbr, cum, alias = _tables()
    rng = np.random.default_rng(1)
    r = (rng.integers(0, nbr.shape[0] - 1, 10) if roots == "mixed"
         else rng.integers(0, 10, 10)).astype(np.int32)
    if roots == "mixed":
        r[:3] = [0, 4, 9]
    atab = alias if layout == "alias" else None
    key = jax.random.key(7)
    levels, adjs = jax.jit(
        lambda n_, c_, r_, k_, a_: JL.sample_layerwise_rows(
            n_, c_, r_, SIZES, k_, alias_table=a_),
        compiler_options=_O0)(nbr, cum, r, key, atab)
    got_l, got_a = sample_layerwise_rows(
        torch.from_numpy(nbr), torch.from_numpy(cum), torch.from_numpy(r),
        SIZES, uniforms=_replayed(key, SIZES, layout == "alias"),
        alias_table=None if atab is None else torch.from_numpy(atab))
    for g_, w in zip(got_l, levels):
        assert g_.dtype == torch.int32
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    for g_, w in zip(got_a, adjs):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    pad = nbr.shape[0] - 1
    if roots == "dead":
        pools = got_l[1][len(r):].numpy()
        assert (pools == pad).all() if layout == "alias" \
            else (pools == nbr[r[-1], -1]).all()
    # a generator draws [m] (split) or [3, m] (alias) uniforms a layer
    gen_l, gen_a = sample_layerwise_rows(
        torch.from_numpy(nbr), torch.from_numpy(cum), torch.from_numpy(r),
        SIZES, generator=torch.Generator().manual_seed(0),
        alias_table=None if atab is None else torch.from_numpy(atab))
    assert [len(x) for x in gen_l] == [10, 10 + SIZES[0], 10 + sum(SIZES)]
    for a in gen_a:
        np.testing.assert_allclose(a.sum(1).numpy(), 1.0, rtol=1e-6)


def test_layer_encoder_matches_the_reference():
    """LayerEncoder over two random levels (and a bf16 input level, as a
    dequantized table gives): output and gradients within rtol 1e-5,
    the reference's Dense w_{i} carried across."""
    rng = np.random.default_rng(2)
    sizes = [5, 9, 14]
    layers = [rng.normal(size=(m, D)).astype(np.float32) for m in sizes]
    adjs = [rng.random((sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(2)]
    cot = rng.normal(size=(5, DIM)).astype(np.float32)
    jm = JLayerEncoder(DIM)
    params = jax.jit(jm.init, compiler_options=_O0)(
        jax.random.key(0), layers, adjs)

    def loss(p):
        out = jm.apply(p, layers, adjs)
        return (out * cot).sum(), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                compiler_options=_O0)(params)
    m = LayerEncoder(D, DIM, 2)
    m.load_state_dict(flax_to_state_dict(params))
    got = m([torch.from_numpy(x) for x in layers],
            [torch.from_numpy(a) for a in adjs])
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    _close_trees(state_dict_to_flax({k: p.grad for k, p in
                                     m.named_parameters()}),
                 want_g["params"])
    with pytest.raises(ValueError, match="adjacencies"):
        m([torch.from_numpy(x) for x in layers[:2]],
          [torch.from_numpy(a) for a in adjs])


# -- the model in its estimator -----------------------------------------------

def _pair(engines, **kw):
    """(port NodeEstimator, reference NodeEstimator): the layerwise model
    on the device sampler over an int8 feature table with a float32
    scale, the host closure flow for evaluation."""
    pg, jg = engines
    params = {"batch_size": B, "learning_rate": LR, "checkpoint_steps": 0,
              "log_steps": 1 << 30}
    store = DeviceFeatureStore(pg, ["feature"], label_fid="label",
                               label_dim=C, quantize="int8", device="cpu")
    jstore = JDeviceFeatureStore(jg, ["feature"], label_fid="label",
                                 label_dim=C, quantize="int8")
    tab = DeviceNeighborTable(pg, cap=CAP, device="cpu")
    jtab = JDeviceNeighborTable(jg, cap=CAP)
    est = NodeEstimator(
        DeviceSampledLayerwiseGCN(C, D, multilabel=False, dim=DIM,
                                  layer_sizes=SIZES,
                                  generator=torch.Generator().manual_seed(0)),
        params, pg, None, label_dim=C, feature_store=store,
        device_sampler=tab, device="cpu",
        eval_dataflow=LayerwiseDataFlow(pg, list(SIZES), sample=False,
                                        feature_ids=["feature"]), **kw)
    jest = JNodeEstimator(
        JLayerwiseGCN(num_classes=C, multilabel=False, dim=DIM,
                      layer_sizes=SIZES),
        params, jg, None, label_fid="label", label_dim=C,
        feature_store=jstore, device_sampler=jtab,
        eval_dataflow=JLayerwiseDataFlow(jg, list(SIZES), sample=False,
                                         feature_ids=["feature"]), **kw)
    return est, jest


def _seeded_uniforms(seed):
    return _replayed(jax.random.fold_in(jax.random.key(31), np.uint32(seed)),
                     SIZES, False)


def test_layerwise_gcn_step_and_adam_match_the_reference(engines):
    """Both estimators' batches (engine roots, sample seeds) equal; on
    the first, with the reference's uniforms for key(31) folded with
    its sample seed replayed: loss, metric and gradients within rtol
    1e-5; then 3 Adam steps with the reference's losses (rtol 1e-5) and
    parameters (atol 1e-3 of lr)."""
    est, jest = _pair(engines)
    assert DeviceSampledLayerwiseGCN.stream_word == 31
    it = est.train_input_fn()
    p_seed(4)
    pb = [next(it) for _ in range(3)]
    jit_ = jest.train_input_fn()
    j_seed(4)
    jb = [next(jit_) for _ in range(3)]
    for a, b in zip(pb, jb):
        assert sorted(a) == sorted(b)
        _same(a["rows"][0], b["rows"][0])
        assert a["sample_seed"] == b["sample_seed"]
        a["sample_uniforms"] = _seeded_uniforms(a["sample_seed"])
    first = _merged(_to_device_tree(jb[0]), jest.static_batch)
    params = jax.jit(jest.model.init, compiler_options=_O0)(
        jax.random.key(0), first)["params"]

    def loss_fn(p):
        out = jest.model.apply({"params": p}, first)
        return out.loss, out.metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True), compiler_options=_O0)(params)
    est.model.load_state_dict(flax_to_state_dict(params))
    out = est.model({**_to_device(pb[0], CPU), **est.static_batch})
    out.loss.backward()
    assert float(out.loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(out.metric) == pytest.approx(float(jmetric), rel=1e-5)
    _close_trees(state_dict_to_flax({k: p.grad for k, p in
                                     est.model.named_parameters()}), jgrads)
    jest.state = JTrainState.create(
        apply_fn=jest.model.apply, params=params, tx=jest.tx, extra_vars={},
        skipped_steps=jnp.zeros((), jnp.int32))
    step_fn = jax.jit(jest._make_one_step(), compiler_options=_O0)
    est.model.zero_grad(set_to_none=True)
    for i, (a, b) in enumerate(zip(pb, jb)):
        jest.state, jloss, _ = step_fn(jest.state, _merged(
            _to_device_tree(b), jest.static_batch))
        res = est.train(iter([a]), max_steps=i + 1)
        assert res["loss"] == pytest.approx(float(jloss), rel=1e-5)
        _close_trees(state_dict_to_flax(est.model.state_dict()),
                     jest.state.params, rtol=0, atol=1e-3 * LR)


def test_eval_via_flow_batches_and_errors_match_the_reference(engines):
    """NodeEstimator(eval_via_flow=True): the reference's two
    ValueErrors; the eval sweep's host batches (levels, adjacencies,
    features, engine labels, masks) byte-identical to the reference's;
    evaluate() over them from the same parameters within rtol 1e-5.
    The layerwise model refuses a fused-only batch and row-sharded
    tables."""
    pg, jg = engines
    with pytest.raises(ValueError, match="only applies with a "
                                         "device_sampler"):
        NodeEstimator(DeviceSampledLayerwiseGCN(C, D), {}, pg, None,
                      eval_via_flow=True, device="cpu")
    tab = DeviceNeighborTable(pg, cap=CAP, device="cpu")
    store = DeviceFeatureStore(pg, ["feature"], device="cpu")
    with pytest.raises(ValueError, match="needs an eval_dataflow"):
        NodeEstimator(DeviceSampledLayerwiseGCN(C, D), {}, pg, None,
                      feature_store=store, device_sampler=tab,
                      eval_via_flow=True, device="cpu")
    est, jest = _pair(engines, eval_via_flow=True)
    sweep, jsweep = list(est.eval_sweep_input_fn()), \
        list(jest.eval_sweep_input_fn())
    assert len(sweep) == len(jsweep) == est.eval_sweep_steps()
    for a, b in zip(sweep, jsweep):
        assert sorted(a) == sorted(b)
        assert "sample_seed" not in a
        for k in a:
            for x, y in zip(*(v if isinstance(v, list) else [v]
                              for v in (a[k], b[k]))):
                _same(x, y)
    first = _merged(_to_device_tree(jsweep[0]), jest.static_batch)
    params = jax.jit(jest.model.init, compiler_options=_O0)(
        jax.random.key(0), first)["params"]
    jest.state = JTrainState.create(
        apply_fn=jest.model.apply, params=params, tx=jest.tx, extra_vars={},
        skipped_steps=jnp.zeros((), jnp.int32))
    est.model.load_state_dict(flax_to_state_dict(params))
    got = est.evaluate(iter(sweep), len(sweep))
    want = jest.evaluate(iter(jsweep), len(jsweep))
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["metric"] == pytest.approx(want["metric"], rel=1e-5)
    fused = {**_to_device(sweep[0], CPU), "rows": [torch.zeros(2).int()],
             "nbrcum_table": torch.zeros((3, 4), dtype=torch.int32)}
    del fused["adjs"]
    with pytest.raises(ValueError, match="split nbr/cum"):
        est.model(fused)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        DeviceSampledLayerwiseGCN(C, D, table_mesh=object())


class _CpuLoop(GraphedLoop):
    """The K-step loop's host side on the CPU: its registered
    generators, re-seeded by the real `_seed` with the model's stream
    word before each window, feed K eager steps."""

    def __init__(self, steps):
        self.steps = steps
        self._sample_gens = [torch.Generator() for _ in range(steps)]
        self._dropout_gens = [torch.Generator() for _ in range(steps)]
        self.windows = 0

    def run(self, est, batches):
        self._seed(est, batches)
        self.windows += 1
        outs = [est._train_step({**b, "sample_generator": g})
                for b, g in zip(batches, self._sample_gens)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))


@pytest.mark.parametrize("word", [31, 17])
def test_k_step_windows_reseed_with_the_layerwise_word(engines, word,
                                                       monkeypatch):
    """Two windows of 4 through the loop's host side train exactly as 8
    eager steps (stream word 31, as the eager step seeds its draw); with
    the supervised word 17 forced, the draws and so the parameters
    differ."""
    est_of = {}
    for k in (4, 1):
        est, _ = _pair(engines)
        est.steps_per_loop = k
        loop = _CpuLoop(k)
        monkeypatch.setattr(est, "_train_window",
                            lambda bs, e=est, lp=loop: lp.run(e, bs))
        if k == 4:
            monkeypatch.setattr(DeviceSampledLayerwiseGCN, "stream_word",
                                word)
        p_seed(9)
        res = est.train(est.train_input_fn, max_steps=8)
        monkeypatch.setattr(DeviceSampledLayerwiseGCN, "stream_word", 31)
        assert loop.windows == (2 if k == 4 else 0)
        est_of[k] = (est, res["losses"])
    (g, lg), (e, le) = est_of[4], est_of[1]
    same = lg == le and all(
        torch.equal(v, e.model.state_dict()[n])
        for n, v in g.model.state_dict().items())
    assert same == (word == 31)


# -- the runner ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "device"])
def test_fastgcn_runner_runs_a_few_steps(mode, monkeypatch):
    """run_fastgcn for 6 steps on a small stand-in (300 nodes, 16
    features), the host LayerwiseDataFlow or --device_sampler, both
    evaluating on the host closures: finite, nothing skipped, a test
    micro-F1; without --device it needs the card."""
    from euler_tpu_torch.examples import common, run_fastgcn

    monkeypatch.setattr(common, "get_dataset", lambda name: engine_from_arrays(
        synthetic_citation(n=300, d=16, num_classes=3, seed=1, val=60,
                           test=100)))
    argv = ["--max_steps", "6", "--layer_sizes", "32,32"]
    if mode == "device":
        argv.append("--device_sampler")
    res = run_fastgcn.main([*argv, "--device", "cpu"])
    assert res["train_global_step"] == 6
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"])
    assert 0.0 <= res["test_metric"] <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fastgcn.main(argv)
