"""Unsupervised GraphSAGE of the PyTorch port against the JAX package, on
the CPU: the host-fed UnsuperviseModel base, DeviceSampledUnsupervisedSage
after convert.py with replayed uniforms (float32 features, and int8 with
a bfloat16 scale on a grid bfloat16 holds), the K-step loop's stream
words, the ppi stand-in's shape and the unsupervised runner."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.models.graphsage import \
    DeviceSampledUnsupervisedSage as JaxUnsupSage
from euler_tpu.mp_utils.base import UnsuperviseModel as JaxUnsuperviseModel
from euler_tpu.parallel.feature_store import \
    DeviceFeatureStore as JaxDeviceFeatureStore
from euler_tpu.utils.layers import Embedding as JaxEmbedding
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.graphed_loop import GraphedLoop
from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledUnsupervisedSage,
)
from euler_tpu_torch.mp_utils.base import UnsuperviseModel
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.utils.layers import Embedding

N, C, B, D, DIM, FANOUTS, NEGS, LR = 50, 4, 16, 16, 8, (3, 2), 5, 0.01

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time (run op by op, a
# flax init compiles each op)
_O0 = {"xla_backend_optimization_level": 0}


def _apply(jm, params, batch):
    """jm.apply(params, batch) jitted at _O0 (its str metric_name is no
    array: it is taken from the trace)."""
    names = []

    def f(p, b):
        out = jm.apply(p, b)
        names.append(out.metric_name)
        return out._replace(metric_name=None)

    out = jax.jit(f, compiler_options=_O0)(params, batch)
    return out._replace(metric_name=names[0])


def _t(x):
    return torch.from_numpy(np.array(x))


def _graph():
    """50 nodes, 4 of them isolated, 8 above the cap of 4."""
    return synthetic_citation(n=N, d=D, num_classes=3, seed=0,
                              intra_degree=2.0, inter_degree=1.0)


def _roots(g):
    """B roots, the first an isolated node: its positive is the pad
    row, so the mask is exercised."""
    roots = np.random.default_rng(4).integers(0, N, B).astype(np.int32)
    roots[0] = np.flatnonzero(np.diff(g.offsets) == 0)[0]
    return roots


def _on_bf16_grid(feats):
    """q·2^-5 with integer |q| <= 127 and 127 in every column: int8
    quantization's scale is exactly 2^-5 and every row and neighbor mean
    of this test is the same in the port's rounding order and the
    reference's (see tests/test_torch_train.py)."""
    q = np.rint(feats / np.abs(feats).max(0) * 127)
    return (q * 2.0 ** -5).astype(np.float32)


def _reference_state(jest, jmodel, model, jbatch):
    """The reference estimator's state over the port model's fresh
    parameters, converted; the reference's own init tree (traced, not
    run) has the same names and shapes."""
    params = state_dict_to_flax(model.state_dict())
    want = jax.eval_shape(jmodel.init, jax.random.key(0), jbatch)["params"]
    shapes = [{jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(t)[0]}
              for t in (want, params)]
    assert shapes[0] == shapes[1]
    jest.state = JaxTrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params), tx=jest.tx,
        extra_vars={}, skipped_steps=jnp.zeros((), jnp.int32))


# -- the host-fed base ---------------------------------------------------------

class _JaxSrcModel(JaxUnsuperviseModel):
    def embed(self, batch):
        return JaxEmbedding(self.max_id + 1, self.dim, name="src")(
            batch["src"])


class _SrcModel(UnsuperviseModel):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.src = Embedding(self.max_id + 1, self.dim)

    def embed(self, batch):
        return self.src(batch["src"])


@pytest.mark.parametrize("pos_shape", ["[B]", "[B, 1]"])
def test_unsupervise_model_matches_the_reference(pos_shape):
    """The base's loss (sigmoid BCE of one positive and num_negs
    negatives, each averaged) within 1e-6 relative and its MRR equal,
    over one shared ctx_emb table, with the flax params converted.
    No negative is its row's positive, so no logit ties by rounding."""
    rng = np.random.default_rng(6)
    src = rng.integers(0, N, B).astype(np.int32)
    pos = rng.integers(0, N, B).astype(np.int32)
    negs = (pos[:, None] + rng.integers(1, N, (B, NEGS))) % N
    negs = negs.astype(np.int32)
    if pos_shape == "[B, 1]":
        pos = pos[:, None]
    jm = _JaxSrcModel(dim=DIM, max_id=N - 1, num_negs=NEGS)
    jbatch = {"src": jnp.asarray(src), "pos": jnp.asarray(pos),
              "negs": jnp.asarray(negs)}
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(1),
                                                    jbatch)
    want = _apply(jm, params, jbatch)
    m = _SrcModel(dim=DIM, max_id=N - 1, num_negs=NEGS)
    m.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = m({"src": _t(src), "pos": _t(pos), "negs": _t(negs)})
    assert got.metric_name == want.metric_name == "mrr"
    assert float(got.loss) == pytest.approx(float(want.loss), rel=1e-6)
    assert float(got.metric) == pytest.approx(float(want.metric), rel=1e-7)
    np.testing.assert_array_equal(got.embedding.numpy(),
                                  np.asarray(want.embedding))


# -- DeviceSampledUnsupervisedSage ---------------------------------------------

def _replayed(seed, n):
    """The reference's draws for sample_seed: fold_in(key(29), seed)
    split three ways, into the fanout (one split per hop), the
    positives [B, 1] and the negatives [B, num_negs]."""
    kf, kp, kn = jax.random.split(
        jax.random.fold_in(jax.random.key(29), seed), 3)
    fan = []
    for k in FANOUTS:
        kf, sub = jax.random.split(kf)
        fan.append(_t(jax.random.uniform(sub, (n, k))))
        n *= k
    return {"sample_uniforms": fan,
            "pos_uniforms": _t(jax.random.uniform(kp, (B, 1))),
            "neg_uniforms": _t(jax.random.uniform(kn, (B, NEGS)))}


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_unsup_sage_matches_the_reference(scale_dtype):
    """After convert.py, on the reference's uniforms, int8 features with
    a float32 scale and with a bfloat16 scale (features on a grid
    bfloat16 holds, as tests/test_torch_train.py explains): loss and
    the embedding within 1e-5 (float32) or 2^-7 (bfloat16) of the
    largest value, the MRR within 1e-6, and one Adam step's parameters
    within 1e-5 or 2^-7 of the largest parameter. The deepest hop runs
    through gather_mean's plain version (the CPU path). The first root
    has no neighbor: its pair is masked out in both."""
    g = _graph()
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    if scale_dtype == "bfloat16":
        feats = _on_bf16_grid(feats)
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=C,
                                       device="cpu", keep_host=True)
    store = DeviceFeatureStore.from_arrays(
        feats, quantize="int8", scale_dtype=getattr(torch, scale_dtype),
        device="cpu")
    jstore = JaxDeviceFeatureStore.from_arrays(
        feats, quantize="int8", scale_dtype=getattr(jnp, scale_dtype))
    neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32), device="cpu")
    roots, seed = _roots(g), np.uint32(7)
    static = {**tab.tables, **neg.tables, "feature_table": store.features,
              "feature_scale": store.feature_scale}
    nbr, cum = tab.host_tables
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              "nbr_table": jnp.asarray(nbr), "cum_table": jnp.asarray(cum),
              "neg_rows": jnp.asarray(neg.rows.numpy()),
              "neg_cum": jnp.asarray(neg.cum.numpy()),
              "feature_table": jstore.features,
              "feature_scale": jstore.feature_scale}
    model = DeviceSampledUnsupervisedSage(
        tab.pad_row, D, dim=DIM, fanouts=FANOUTS, num_negs=NEGS,
        generator=torch.Generator().manual_seed(0))
    jmodel = JaxUnsupSage(num_rows=tab.pad_row, dim=DIM, fanouts=FANOUTS,
                          num_negs=NEGS)
    jest = JaxBaseEstimator(jmodel, {"optimizer": "adam",
                                     "learning_rate": LR})
    _reference_state(jest, jmodel, model, jbatch)
    batch = {"rows": [_t(roots)], "sample_seed": int(seed),
             **_replayed(seed, B)}

    def outputs(params, b):
        out = jest.state.apply_fn({"params": params}, b)
        return out.embedding, out.loss, out.metric

    # one jitted program per case: the reference's step (it returns the
    # loss and metric before its update) and its embedding
    step = jest._make_one_step()
    (state, jloss, jmetric), ref_emb = jax.jit(
        lambda st, b: (step(st, b), outputs(st.params, b)[0]),
        compiler_options=_O0)(jest.state, jbatch)
    ref_emb = np.asarray(ref_emb)
    with torch.no_grad():
        out = model({**batch, **static})
        _, pos, _ = model.sample({**batch, **static})
    assert int(pos[0]) == tab.pad_row
    rel = 1e-5 if scale_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(out.embedding.numpy(), ref_emb, rtol=0,
                               atol=rel * np.abs(ref_emb).max())
    assert abs(float(out.loss) - float(jloss)) <= rel * float(jloss)
    assert abs(float(out.metric) - float(jmetric)) <= 1e-6
    est = BaseEstimator(model, {"optimizer": "adam", "learning_rate": LR,
                                "checkpoint_steps": 0}, device="cpu")
    est.static_batch = static
    est.train(iter([batch]), max_steps=1)
    want = jax.tree_util.tree_leaves(state.params)
    got = jax.tree_util.tree_leaves(state_dict_to_flax(model.state_dict()))
    tol = rel * max(float(np.abs(w).max()) for w in want)
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_, np.asarray(w), rtol=0, atol=tol)


def test_unsup_sage_refuses_what_is_not_ported():
    """The pool aggregators and the fused and alias layouts are ported
    now (tests/test_torch_encoders.py holds them against the reference):
    meanpool builds and trains a step over the fused table. The gcn
    aggregator raises TypeError, as the reference's SageEncoder does;
    the alias layout refuses row sharding, as the reference's does
    (row-sharded tables themselves: tests/test_torch_parallel.py)."""
    g = _graph()
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=C,
                                       device="cpu", fused=True)
    neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32), device="cpu")
    model = DeviceSampledUnsupervisedSage(
        tab.pad_row, D, dim=DIM, fanouts=FANOUTS, aggregator="meanpool",
        generator=torch.Generator().manual_seed(0))
    out = model({"rows": [_t(_roots(g))], "sample_seed": 1, **tab.tables,
                 **neg.tables, "feature_table": _t(feats)})
    assert torch.isfinite(out.loss) and out.embedding.shape == (B, DIM)
    with pytest.raises(TypeError, match="concat"):
        DeviceSampledUnsupervisedSage(10, D, aggregator="gcn")
    with pytest.raises(ValueError, match="replicated"):
        DeviceNeighborTable.from_arrays(np.zeros((3, 2), np.int32),
                                        np.zeros((3, 2), np.float32),
                                        device="cpu", alias=True,
                                        shard_rows=True)


# -- the K-step loop's stream words --------------------------------------------

class _CpuLoop(GraphedLoop):
    """The K-step loop's host side on the CPU: its K registered
    generators, re-seeded by the real `_seed` before each window, feed
    K eager steps (a CUDA graph replay reads them the same way)."""

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


def _stream_setup():
    g = _graph()
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=C,
                                       device="cpu")
    store = DeviceFeatureStore.from_arrays(feats, np.zeros((N + 1, 3)),
                                           device="cpu")
    neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32), device="cpu")
    static = {**tab.tables, **neg.tables, "feature_table": store.features,
              "label_table": store.labels}
    models = {
        17: lambda: DeviceSampledGraphSage(
            3, D, dim=DIM, fanouts=FANOUTS,
            generator=torch.Generator().manual_seed(0)),
        29: lambda: DeviceSampledUnsupervisedSage(
            tab.pad_row, D, dim=DIM, fanouts=FANOUTS,
            generator=torch.Generator().manual_seed(0)),
        23: lambda: DeviceSampledSkipGram(
            tab.pad_row, dim=DIM, walk_len=3,
            generator=torch.Generator().manual_seed(0)),
    }
    return static, models


@pytest.mark.parametrize("word", [17, 29, 23])
def test_graphed_loop_seeds_each_model_with_its_stream_word(word,
                                                            monkeypatch):
    """The K-step loop re-seeds its generators with the model's stream
    word (17 supervised, 29 unsupervised GraphSAGE, 23 skip-gram): 2
    windows of 4 through the loop's host side (_CpuLoop) train exactly
    as 8 eager steps; with the supervised word forced on the other
    models, the draws, and so the parameters, differ."""
    static, models = _stream_setup()
    rng = np.random.default_rng(8)
    batches = [{"rows": [_t(rng.integers(0, N, B).astype(np.int32))],
                "sample_seed": 100 + i} for i in range(8)]

    def trained(k, loop_cls=_CpuLoop):
        model = models[word]()
        est = BaseEstimator(model, {"learning_rate": LR, "checkpoint_steps": 0,
                                    "steps_per_loop": k}, device="cpu")
        est.static_batch = static
        loop = loop_cls(k)
        monkeypatch.setattr(est, "_train_window",
                            lambda bs: loop.run(est, bs))
        res = est.train(iter(batches), max_steps=8)
        assert loop.windows == (2 if k == 4 else 0)
        return res["losses"], model.state_dict()

    assert type(models[word]()).stream_word == word
    eager, graphed = trained(1), trained(4)
    assert eager[0] == graphed[0]
    for k, v in eager[1].items():
        assert torch.equal(graphed[1][k], v), k
    if word != 17:
        class _Word17(_CpuLoop):
            def _seed(self, est, bs):
                cls = type(est.model)
                monkeypatch.setattr(cls, "stream_word", 17)
                try:
                    super()._seed(est, bs)
                finally:
                    monkeypatch.setattr(cls, "stream_word", word)

        wrong = trained(4, _Word17)
        assert wrong[0] != eager[0]


# -- the ppi stand-in and the runner -------------------------------------------

def test_dataset_shapes_are_pinned_to_the_reference():
    """The port's stand-in shapes (ppi added) and synthetic_citation's
    defaults, which ppi's missing degrees fall back to, equal the
    reference's."""
    from euler_tpu.dataset import _CITATION_SHAPES as ref_shapes
    from euler_tpu.dataset.base_dataset import \
        synthetic_citation as ref_synth
    from euler_tpu_torch.dataset import _CITATION_SHAPES

    assert "ppi" in _CITATION_SHAPES
    for name, shape in _CITATION_SHAPES.items():
        assert shape == ref_shapes[name], name
    want = {k: p.default for k, p in
            inspect.signature(ref_synth).parameters.items()
            if p.default is not inspect.Parameter.empty}
    got = {k: p.default for k, p in
           inspect.signature(synthetic_citation).parameters.items()
           if p.default is not inspect.Parameter.empty}
    assert got == want


def test_unsupervised_runner_runs_a_few_steps_on_the_cpu():
    """run_graphsage --mode unsupervised --device_sampler on the ppi
    stand-in for 12 steps and 2 evaluation batches: finite, nothing
    skipped, the MRR in (0, 1]; int8 features too."""
    from euler_tpu_torch.examples import run_graphsage

    for extra in ([], ["--int8_features"]):
        res = run_graphsage.main(
            ["--device_sampler", "--mode", "unsupervised", "--dataset",
             "ppi", "--device", "cpu", "--max_steps", "12",
             "--eval_steps", "2", *extra])
        assert res["train_global_step"] == 12
        assert res["train_skipped_steps"] == 0
        assert np.isfinite(res["train_loss"]) and np.isfinite(
            res["eval_loss"])
        assert 0.0 < res["eval_metric"] <= 1.0
