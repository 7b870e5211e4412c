"""The rest of the node and embedding zoo in the port against the JAX
package, on the CPU: SparseEmbedding's three combiners, ShallowEncoder,
SparseSageEncoder, spmm, the host-fed GeniePath model (the runner's own
SuperviseModel over a GenieEncoder) and ScalableGraphSage over two Adam
steps with its cache, the solution layer's heads, losses, sampler,
models and batches, and SampleEstimator's batches.

Inputs are made with numpy from a seed; the reference's parameters are
carried into the port by euler_tpu_torch.convert. Tolerances (float32):
forward outputs rtol 1e-5 (atol 1e-6); gradients within 1e-5 of the
largest gradient of the tree; after two Adam steps every parameter and
cache row within 1e-5 of the tree's largest value; batches exact. The
reference's programs are jitted at XLA's lowest backend optimization
level."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.contrib.spmm import spmm as jspmm
from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth
from euler_tpu.estimator import SampleEstimator as JSampleEstimator
from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.graph import seed as j_seed
from euler_tpu.models import ScalableGraphSage as JScalableGraphSage
from euler_tpu.mp_utils import SuperviseModel as JSuperviseModel
from euler_tpu.solution import base_solution as JS
from euler_tpu.utils import encoders as JE
from euler_tpu.utils.layers import SparseEmbedding as JSparseEmbedding
from euler_tpu_torch.contrib import spmm
from euler_tpu_torch.convert import (
    flax_to_state_dict, state_dict_to_flax, state_dict_to_flax_variables,
)
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.estimators import SampleEstimator
from euler_tpu_torch.examples.run_geniepath import GeniePathModel
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.models.graphsage import ScalableGraphSage
from euler_tpu_torch.models.kg_models import TransE
from euler_tpu_torch.solution import base_solution as PS
from euler_tpu_torch.utils.encoders import ShallowEncoder, SparseSageEncoder
from euler_tpu_torch.utils.layers import SparseEmbedding

_O0 = {"xla_backend_optimization_level": 0}
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_tree(got, want, rel=GRAD_REL):
    """Every leaf within rel of the tree's largest |value|."""
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    wl = [np.asarray(w, np.float32) for w in jax.tree_util.tree_leaves(want)]
    top = max(float(np.abs(w).max()) for w in wl)
    for g_, w in zip(jax.tree_util.tree_leaves(got), wl):
        assert np.abs(np.asarray(g_, np.float32) - w).max() <= rel * top


def _port_grads(module):
    return {"params": state_dict_to_flax(
        {k: p.grad for k, p in module.named_parameters()})}


def _t(tree):
    """numpy leaves (and lists of them) → torch."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_j(v) for v in tree]
    return jnp.asarray(tree)


def _ref_module(jm, args, cot):
    """The reference module's init, its output and the gradient of
    sum(output · cot) over its params, jitted."""
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0),
                                                    *args)

    def f(p):
        out = jm.apply(p, *args)
        return (out * cot).sum(), out

    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True),
                          compiler_options=_O0)(params)
    return params, out, g


def _check_module(module, jm, args, targs, rng):
    """Forward and gradients of a port module against the reference's,
    the port's fresh tree shaped as flax's."""
    shape = jax.eval_shape(jm.init, jax.random.key(0), *args)
    out_shape = jax.eval_shape(jm.apply, shape, *args).shape
    cot = rng.normal(size=out_shape).astype(np.float32)
    params, want, want_g = _ref_module(jm, args, jnp.asarray(cot))
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        module.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    module.load_state_dict(flax_to_state_dict(params))
    got = module(*targs)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_tree(_port_grads(module), want_g)


def _ref_model(jm, batch):
    """(params, loss, metric, embedding, grads) of a ModelOutput model."""
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0), batch)

    def f(p):
        out = jm.apply(p, batch)
        return out.loss, (out.metric, out.embedding)

    (loss, (m, e)), g = jax.jit(jax.value_and_grad(f, has_aux=True),
                                compiler_options=_O0)(params)
    return params, loss, m, e, g


def _check_model(model, jm, batch, metric_name):
    params, want_l, want_m, want_e, want_g = _ref_model(jm, _j(batch))
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        model.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    model.load_state_dict(flax_to_state_dict(params))
    out = model(_t(batch))
    out.loss.backward()
    assert out.metric_name == metric_name
    _close(out.loss.detach(), want_l)
    _close(out.metric, want_m)
    _close(out.embedding.detach(), want_e)
    _close_tree(_port_grads(model), want_g)


# -- layers, encoders, spmm ------------------------------------------------

@pytest.mark.parametrize("combiner", ["mean", "sum", "max"])
def test_sparse_embedding_matches_the_reference(combiner):
    """Padded ids [6, 5] over a 9-row table (pad id 0, a row of pads
    only, negative and out-of-range ids that wrap, an id repeated within
    a row so max ties): the combined rows and the table's gradient."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 12, (6, 5)).astype(np.int32)
    ids[1] = 0
    ids[2, :3] = [4, 4, 0]
    ids[3, 0] = -3
    _check_module(SparseEmbedding(9, 4, combiner=combiner),
                  JSparseEmbedding(9, 4, combiner=combiner),
                  (jnp.asarray(ids),), (torch.from_numpy(ids),), rng)


@pytest.mark.parametrize("combiner,max_id,feats", [
    ("concat", 7, True), ("add", 7, True), ("concat", 7, False),
    ("concat", 0, True)])
def test_shallow_encoder_matches_the_reference(combiner, max_id, feats):
    """Id embedding and/or a Dense over 5 features, concatenated or
    added: output and gradients."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 8, 6).astype(np.int32)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    jm = JE.ShallowEncoder(dim=4, max_id=max_id, combiner=combiner)
    module = ShallowEncoder(4, max_id=max_id, combiner=combiner, in_dim=5)
    args = (jnp.asarray(ids), jnp.asarray(x)) if feats \
        else (jnp.asarray(ids),)
    targs = (torch.from_numpy(ids), torch.from_numpy(x)) if feats \
        else (torch.from_numpy(ids),)
    if not feats:
        module = ShallowEncoder(4, max_id=max_id, combiner=combiner)
    _check_module(module, jm, args, targs, rng)
    assert module.out_dim == (8 if combiner == "concat" and feats
                              and max_id else 4)


def test_sparse_sage_encoder_matches_the_reference():
    """Three hops of padded sparse ids ([4, 3], [8, 3], [16, 3]) through
    sp_emb and a two-hop sage: output and gradients."""
    rng = np.random.default_rng(2)
    layers = [rng.integers(0, 10, (n, 3)).astype(np.int32)
              for n in (4, 8, 16)]
    jm = JE.SparseSageEncoder(dim=4, fanouts=(2, 2), num_embeddings=10)
    _check_module(SparseSageEncoder(4, (2, 2), 10), jm,
                  ([jnp.asarray(x) for x in layers],),
                  ([torch.from_numpy(x) for x in layers],), rng)


@pytest.mark.parametrize("weighted,normalize", [
    (False, False), (True, False), (False, True), (True, True)])
def test_spmm_matches_the_reference(weighted, normalize):
    """A 30-edge list over 7 rows (a destination outside the rows, a
    source index past the end and a negative one, which jnp's indexing
    clamps and wraps): the product and the gradients of x and the
    edge weights."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 4)).astype(np.float32)
    ei = rng.integers(0, 7, (2, 30)).astype(np.int32)
    ei[1, 0], ei[0, 1], ei[0, 2] = 9, 11, -2
    w = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    cot = rng.normal(size=(6, 4)).astype(np.float32)

    def jf(x_, w_):
        out = jspmm(jnp.asarray(ei), x_, 6, w_ if weighted else None,
                    normalize)
        return (out * cot).sum(), out

    (_, want), (gx, gw) = jax.jit(
        jax.value_and_grad(jf, argnums=(0, 1), has_aux=True),
        compiler_options=_O0)(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = spmm(torch.from_numpy(ei), tx, 6, tw if weighted else None,
               normalize)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_tree({"x": tx.grad, "w": tw.grad if weighted else
                 torch.zeros(30)}, {"x": gx, "w": gw})


# -- host-fed GeniePath and ScalableGraphSage -------------------------------

class _JGeniePathModel(JSuperviseModel):
    """The reference runner's GeniePathModel
    (examples/geniepath/run_geniepath.py:49-52) at a small width."""

    dim: int = 6
    fanouts: tuple = (3, 2)

    def embed(self, batch):
        return JE.GenieEncoder(dim=self.dim, fanouts=self.fanouts,
                               name="enc")(batch["layers"])


def test_host_fed_geniepath_model_matches_the_reference():
    """GeniePathModel (GenieEncoder "enc" of width 6 over fanouts 3, 2,
    then the logits of 3 classes) on a host fanout batch of 4 roots:
    loss, micro-F1, embedding and every gradient."""
    rng = np.random.default_rng(4)
    layers = [rng.normal(size=(n, 5)).astype(np.float32)
              for n in (4, 12, 24)]
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    batch = {"layers": layers, "labels": labels}
    model = GeniePathModel(3, 5, 6, (3, 2), multilabel=False)
    _check_model(model, _JGeniePathModel(num_classes=3, multilabel=False),
                 batch, "f1")


def test_host_fed_scalable_sage_two_steps_match_the_reference():
    """ScalableGraphSage (two layers, the float32 cache over 21 rows) on
    two host one-hop batches whose roots repeat, one Adam step each in
    both estimators: the loss, every parameter and the cache after each
    step (the second step reads the rows the first wrote), and an
    evaluation that reads the cache and writes nothing."""
    n, d, k, b = 20, 5, 3, 8
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n + 1, d)).astype(np.float32)
    batches = []
    for _ in range(2):
        ids0 = rng.integers(0, 6, b).astype(np.int32)
        ids1 = rng.integers(0, n, b * k).astype(np.int32)
        batches.append({"ids": [ids0, ids1],
                        "layers": [feats[ids0], feats[ids1]],
                        "labels": np.eye(3, dtype=np.float32)[
                            rng.integers(0, 3, b)]})
    jm = JScalableGraphSage(num_classes=3, multilabel=False, dim=4,
                            num_layers=2, max_id=n)
    model = ScalableGraphSage(3, d, multilabel=False, dim=4, num_layers=2,
                              max_id=n,
                              generator=torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax_variables(model.state_dict()))
    want = jax.eval_shape(jm.init, jax.random.key(0), _j(batches[0]))
    assert jax.tree_util.tree_map(np.shape, want) == \
        jax.tree_util.tree_map(np.shape, variables)
    jest = JaxBaseEstimator(jm, {"optimizer": "adam", "learning_rate": 0.01})
    params = variables.pop("params")
    jest.state = JaxTrainState.create(
        apply_fn=jm.apply, params=params, tx=jest.tx, extra_vars=variables,
        skipped_steps=jnp.zeros((), jnp.int32))
    step = jax.jit(jest._make_one_step(), donate_argnums=(0,),
                   compiler_options=_O0)
    est = BaseEstimator(model, {"optimizer": "adam", "learning_rate": 0.01,
                                "checkpoint_steps": 0}, device="cpu")
    for i, batch in enumerate(batches):
        jest.state, jloss, _ = step(jest.state, _j(batch))
        res = est.train(iter([batch]), max_steps=i + 1)
        assert abs(res["loss"] - float(jloss)) <= 1e-5 * max(
            1.0, abs(float(jloss)))
        got = state_dict_to_flax_variables(est.model.state_dict())
        _close_tree(got["params"], jest.state.params)
        _close_tree(got["cache"], jest.state.extra_vars["cache"])
    before = est.model.encoder.cache_1.h.clone()
    ev = est.evaluate(iter(batches), 2)
    jout = [jm.apply({"params": jest.state.params,
                      **jest.state.extra_vars}, _j(bt)) for bt in batches]
    _close(ev["loss"], np.mean([float(o.loss) for o in jout]))
    assert torch.equal(est.model.encoder.cache_1.h, before)


# -- the solution layer -----------------------------------------------------

def test_solution_heads_and_losses_match_the_reference():
    """DenseLogits, PosNegLogits and CosineLogits (one zero embedding
    row, held by the 1e-12 floor; its gradient is NaN in both, the
    norm's at 0) on 5 roots, 1 positive and 4 negatives; sigmoid_loss;
    xent_loss on one-hot and on integer labels: values and input
    gradients (NaN where the reference's is NaN)."""
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(5, 4)).astype(np.float32)
    emb[2] = 0.0
    pos = rng.normal(size=(5, 1, 4)).astype(np.float32)
    negs = rng.normal(size=(5, 4, 4)).astype(np.float32)
    _check_module(PS.DenseLogits(4, 3), JS.DenseLogits(3),
                  (jnp.asarray(emb),), (torch.from_numpy(emb),), rng)
    for jh, ph in ((JS.PosNegLogits(), PS.PosNegLogits()),
                   (JS.CosineLogits(), PS.CosineLogits())):
        def jf(e, p, n):
            pl, nl = jh.apply({}, e, p, n)
            return JS.sigmoid_loss(pl, nl), (pl, nl)

        (jl, (jpl, jnl)), jg = jax.jit(
            jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True),
            compiler_options=_O0)(jnp.asarray(emb), jnp.asarray(pos),
                                  jnp.asarray(negs))
        te, tp, tn = (torch.from_numpy(a).requires_grad_()
                      for a in (emb, pos, negs))
        pl, nl = ph(te, tp, tn)
        loss = PS.sigmoid_loss(pl, nl)
        loss.backward()
        _close(pl.detach(), jpl)
        _close(nl.detach(), jnl)
        _close(loss.detach(), jl)
        for got_g, want_g in zip((te.grad, tp.grad, tn.grad), jg):
            _close(got_g, want_g)
    logits = rng.normal(size=(5, 3)).astype(np.float32)
    ints = rng.integers(0, 3, 5).astype(np.int32)
    for labels in (np.eye(3, dtype=np.float32)[ints], ints):
        want = JS.xent_loss(jnp.asarray(logits), jnp.asarray(labels))
        got = PS.xent_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels))
        _close(got, want)


def _graphs(seed=0, **kw):
    """The same small citation graph in both packages' engines."""
    kw = {"n": 60, "d": 5, "num_classes": 3, "seed": seed, **kw}
    return (engine_from_arrays(synthetic_citation(**kw)).engine,
            jsynth("t", **kw).engine)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["supervise", "unsupervise"])
def test_solution_batches_match_the_reference(mode):
    """Four batches of each solution's input_fn (supervise: train roots,
    then val roots through input_fn(1); unsupervise: every node, with
    PosNegSampler's positive and negatives) over the same graph, both
    engines seeded alike: every array equal."""
    pg, jg = _graphs()
    if mode == "supervise":
        kw = dict(fanouts=(3, 2), dim=4, num_classes=3, batch_size=5)
        ps, js = PS.SuperviseSolution(pg, **kw), JS.SuperviseSolution(jg,
                                                                      **kw)
        streams = [(ps.input_fn(), js.input_fn()),
                   (ps.input_fn(1), js.input_fn(1))]
    else:
        kw = dict(fanouts=(3, 2), dim=4, max_id=59, num_negs=3,
                  batch_size=5)
        ps, js = (PS.UnsuperviseSolution(pg, **kw),
                  JS.UnsuperviseSolution(jg, **kw))
        streams = [(ps.input_fn(), js.input_fn())]
    p_seed(11)
    j_seed(11)
    for p_it, j_it in streams:
        for _ in range(2):
            _assert_batches_equal(next(p_it), next(j_it))


@pytest.mark.parametrize("mode,multilabel,logits", [
    ("supervise", False, None), ("supervise", True, None),
    ("unsupervise", None, "dot"), ("unsupervise", None, "cosine")])
def test_solution_models_match_the_reference(mode, multilabel, logits):
    """_SageSupModel (softmax or multilabel sigmoid) and _SageUnsupModel
    (dot or cosine head) on a batch of their solution's input_fn: loss,
    metric, embedding and every gradient."""
    pg, _ = _graphs(1)
    p_seed(3)
    if mode == "supervise":
        sol = PS.SuperviseSolution(pg, fanouts=(3, 2), dim=4, num_classes=3,
                                   multilabel=multilabel, batch_size=6)
        jm = JS._SageSupModel(4, (3, 2), 3, multilabel)
        metric = "f1"
    else:
        sol = PS.UnsuperviseSolution(pg, fanouts=(3, 2), dim=4, max_id=59,
                                     num_negs=3, batch_size=6,
                                     logits=logits)
        jm = JS._SageUnsupModel(4, (3, 2), 59, logits)
        metric = "mrr"
    batch = next(sol.input_fn())
    batch.pop("infer_ids")
    for key in ("ids", "weights", "types"):
        batch.pop(key)
    for key in ("pos", "negs"):
        if key in batch:
            batch[key] = batch[key].astype(np.int32)
    _check_model(sol.model, jm, batch, metric)


def test_sample_estimator_batches_match_the_reference(tmp_path):
    """A sample file of 11 records and blank lines, batch_size 4: both
    estimators' streams give the same 6 batches (two full passes, each
    dropping its 3-line tail), as parse_fn sees them."""
    path = tmp_path / "sample.txt"
    lines = [f"{i % 3},{i}" for i in range(11)]
    path.write_text("\n".join(lines[:5]) + "\n\n" + "\n".join(lines[5:])
                    + "\n")

    def parse_fn(recs):
        return {"labels": np.array([int(r.split(",")[0]) for r in recs]),
                "ids": np.array([int(r.split(",")[1]) for r in recs])}

    pest = SampleEstimator(TransE(4, 2, dim=3), {"batch_size": 4},
                           str(path), parse_fn, device="cpu")
    jest = JSampleEstimator(JS.DenseLogits(2), {"batch_size": 4},
                            str(path), parse_fn)
    p_it, j_it = pest.train_input_fn(), jest.train_input_fn()
    got = [next(p_it) for _ in range(6)]
    for g_, w in zip(got, [next(j_it) for _ in range(6)]):
        _assert_batches_equal(g_, w)
    assert [b["ids"].tolist() for b in got[:3]] == \
        [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3]]
