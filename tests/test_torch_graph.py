"""Graph classification in the port against the JAX package, on the
CPU: the metrics (accuracy, auc, get_metric), to_dense, the mutag
stand-in, GatedGraphConv, the five readout pools, GraphGNNNet /
GraphModel in the four mutag runners' configurations, GraphEstimator's
batches and evaluate's graph_mask weighting, and the mutag runners.

Inputs are made with numpy from a seed (graphs from mutag_like with 24
graphs); the reference's parameters are carried into the port by
euler_tpu_torch.convert. Tolerances (float32): forward outputs rtol
1e-5 (atol 1e-6); gradients within 1e-5 of the largest gradient of the
tree; batches and the dataset exact; evaluate's weighted means rtol
1e-6. The reference's programs are jitted at XLA's lowest backend
optimization level (the same HLO, compiled faster)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu import graph_pool as JP
from euler_tpu.convolution import GatedGraphConv as JGatedGraphConv
from euler_tpu.dataset.graph_sets import mutag_like as jmutag_like
from euler_tpu.estimator import GraphEstimator as JGraphEstimator
from euler_tpu.mp_utils import GraphModel as JGraphModel
from euler_tpu.utils import metrics as JM
from euler_tpu.utils import to_dense as JD
from euler_tpu_torch import graph_pool as P
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.convolution import GatedGraphConv
from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.dataset.graph_sets import mutag_like
from euler_tpu_torch.estimator.estimators import GraphEstimator
from euler_tpu_torch.mp_utils.base_gnn import get_conv
from euler_tpu_torch.mp_utils.graph_gnn import GraphModel
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils import to_dense as D

_O0 = {"xla_backend_optimization_level": 0}
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_grads(got, want):
    """Every leaf within GRAD_REL of the tree's largest |gradient|."""
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    wl = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    top = max(float(np.abs(w).max()) for w in wl)
    for g_, w in zip(jax.tree_util.tree_leaves(got), wl):
        assert np.abs(np.asarray(g_) - w).max() <= GRAD_REL * top


def _port_grads(model):
    return {"params": state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()})}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- metrics ------------------------------------------------------------------

def test_accuracy_and_auc_match_the_reference():
    """accuracy: multiclass with integer and one-hot labels, binary
    (logits thresholded at 0.5), with a mask; auc with tied scores (the
    reference ranks ties by a stable sort, not by midrank): exact to
    float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(9, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 9)
    onehot = np.eye(3, dtype=np.float32)[labels]
    mask = (rng.random(9) < 0.6).astype(np.float32)
    binary = rng.random(9).astype(np.float32)
    blabels = rng.integers(0, 2, 9)
    cases = [(logits, labels, None), (logits, labels, mask),
             (logits, onehot, None), (binary, blabels, mask)]
    for lo, la, m in cases:
        want = JM.accuracy(jnp.asarray(lo), jnp.asarray(la),
                           None if m is None else jnp.asarray(m))
        got = M.accuracy(torch.from_numpy(lo), torch.from_numpy(la),
                         None if m is None else torch.from_numpy(m))
        _close(got, want, rtol=1e-6)
    # ties: every score in {0, 0.5, 1}, labels mixed inside each tie
    scores = np.array([0.5, 1, 0, 0.5, 0.5, 1, 0, 0.5, 1, 0], np.float32)
    lab = np.array([1, 0, 1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    want = JM.auc(jnp.asarray(scores), jnp.asarray(lab))
    got = M.auc(torch.from_numpy(scores), torch.from_numpy(lab))
    _close(got, want, rtol=1e-6)
    # the midrank AUC of these ties (0.64), which neither package gives
    diff = scores[lab == 1][:, None] - scores[lab == 0][None, :]
    midrank = float(((diff > 0) + 0.5 * (diff == 0)).mean())
    assert abs(float(got) - midrank) > 0.01
    s = rng.normal(size=40).astype(np.float32)
    y = (rng.random(40) < 0.3).astype(np.float32)
    _close(M.auc(torch.from_numpy(s), torch.from_numpy(y)),
           JM.auc(jnp.asarray(s), jnp.asarray(y)), rtol=1e-6)


def test_get_metric_names_match_the_reference():
    """Every name of the reference's table gives the port's function of
    the same values; an unknown name raises the same error."""
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(6, 5)).astype(np.float32)
    for name in ("mrr", "mr", "hit1", "hit3", "hit10", "MRR"):
        _close(M.get_metric(name)(torch.from_numpy(scores)),
               JM.get_metric(name)(jnp.asarray(scores)), rtol=1e-6)
    logits = rng.normal(size=(6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6)
    for name in ("acc", "accuracy", "f1", "micro_f1"):
        _close(M.get_metric(name)(torch.from_numpy(logits),
                                  torch.from_numpy(labels)),
               JM.get_metric(name)(jnp.asarray(logits),
                                   jnp.asarray(labels)), rtol=1e-6)
    assert M.get_metric("auc") is M.auc and M.f1_score is M.micro_f1
    with pytest.raises(ValueError) as err:
        M.get_metric("nope")
    with pytest.raises(ValueError) as jerr:
        JM.get_metric("nope")
    assert str(err.value) == str(jerr.value)


# -- to_dense -----------------------------------------------------------------

def test_to_dense_matches_the_reference():
    """to_dense_batch and to_dense_adj over 3 graphs of 4, 1 and 5 nodes
    interleaved in the node table, with max_nodes 4 (the third graph's
    fifth node and its edges dropped), repeated and cross-graph edges,
    with and without edge weights: exact."""
    rng = np.random.default_rng(2)
    gi = np.array([0, 2, 0, 1, 2, 2, 0, 2, 0, 2], np.int32)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    ei = rng.integers(0, 10, (2, 30)).astype(np.int32)
    ei[:, 5] = ei[:, 4]
    w = rng.random(30).astype(np.float32)
    dense, mask = D.to_dense_batch(torch.from_numpy(x), torch.from_numpy(gi),
                                   3, 4)
    jdense, jmask = JD.to_dense_batch(jnp.asarray(x), jnp.asarray(gi), 3, 4)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for ew in (None, w):
        got = D.to_dense_adj(torch.from_numpy(ei), torch.from_numpy(gi), 3,
                             4, None if ew is None else torch.from_numpy(ew))
        want = JD.to_dense_adj(jnp.asarray(ei), jnp.asarray(gi), 3, 4,
                               None if ew is None else jnp.asarray(ew))
        _close(got, want, rtol=1e-6, atol=0)


# -- the dataset --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_mutag_copy_is_the_reference(seed):
    """The port's mutag_like (a copy) gives the reference's graphs,
    labels and splits array for array; get_dataset("mutag") is it at
    its defaults."""
    got, want = mutag_like(num_graphs=24, seed=seed), \
        jmutag_like(num_graphs=24, seed=seed)
    assert len(got.graphs) == len(want.graphs) == 24
    for a, b in zip(got.graphs, want.graphs):
        for k in ("x", "edge_index"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    for k in ("labels", "train_indices", "eval_indices"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.num_classes, got.feature_dim, got.name) == \
        (want.num_classes, want.feature_dim, want.name)
    if seed == 0:
        full = get_dataset("mutag")
        ref = jmutag_like()
        assert len(full.graphs) == 188
        np.testing.assert_array_equal(full.eval_indices, ref.eval_indices)


# -- GatedGraphConv and the pools ---------------------------------------------

def _small_graphs(seed=3, n=11, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ei = rng.integers(0, n, (2, 26)).astype(np.int32)
    return rng, x, ei


def _ref_grads(jm, args, cot):
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0),
                                                    *args)

    def loss(p):
        out = jm.apply(p, *args)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                              compiler_options=_O0)(params)
    return params, out, grads


def test_gated_graph_conv_matches_the_reference():
    """GatedGraphConv (3 GRU steps, input 4 zero-padded to 6) on an
    11-node graph: output and every gradient (the GRU's ir..hn and each
    step's w_t) against the reference; get_conv("gated") builds it with
    gate_layers steps; an input wider than out_dim raises; fresh init
    has flax's tree."""
    rng, x, ei = _small_graphs()
    jm = JGatedGraphConv(out_dim=6, num_layers=3)
    cot = rng.normal(size=(11, 6)).astype(np.float32)
    params, want, want_g = _ref_grads(jm, (jnp.asarray(x), jnp.asarray(ei)),
                                      cot)
    conv = get_conv("gated", 4, 6, 0, 2, {"gate_layers": 3},
                    torch.Generator().manual_seed(0))
    assert isinstance(conv, GatedGraphConv) and conv.num_layers == 3
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        conv.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    conv.load_state_dict(flax_to_state_dict(params))
    got = conv(torch.from_numpy(x), torch.from_numpy(ei))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_grads(_port_grads(conv), want_g)
    with pytest.raises(ValueError, match="input dim must be <= out_dim"):
        GatedGraphConv(8, 6)
    rel = get_conv("relation", 4, 4, 0, 2, {"num_relations": 3})
    assert type(rel).__name__ == "RelationConv"
    assert tuple(rel.w_rel.shape) == (3, 4, 4)


POOLS = ["sum", "mean", "max", "attention", "set2set"]


@pytest.mark.parametrize("pool", POOLS)
def test_pool_matches_the_reference(pool):
    """Each readout over 4 graphs of an 11-node table (graph 2 empty,
    graph ids out of order): the graph rows and the gradients of the
    input and of the pool's parameters against the reference."""
    rng, x, _ = _small_graphs(4, d=5)
    gi = np.array([1, 0, 3, 3, 0, 1, 1, 3, 0, 0, 3], np.int32)
    cls = {"sum": "SumPool", "mean": "MeanPool", "max": "MaxPool",
           "attention": "AttentionPool", "set2set": "Set2SetPool"}[pool]
    kw = {"dim": 6} if pool in ("attention", "set2set") else {}
    jm = getattr(JP, cls)(**kw)
    out_w = {"attention": 6, "set2set": 12}.get(pool, 5)
    cot = rng.normal(size=(4, out_w)).astype(np.float32)

    def loss(p, xx):
        out = jm.apply(p, xx, jnp.asarray(gi), 4)
        return (out * cot).sum(), out

    params = jax.jit(lambda k: jm.init(k, jnp.asarray(x), jnp.asarray(gi), 4),
                     compiler_options=_O0)(jax.random.key(0))
    (_, want), (want_g, want_gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        compiler_options=_O0)(params, jnp.asarray(x))
    model = getattr(P, cls)(5, 6) if kw else getattr(P, cls)()
    xt = torch.from_numpy(x).requires_grad_(True)
    if params:
        model.load_state_dict(flax_to_state_dict(params))
    got = model(xt, torch.from_numpy(gi), 4)
    (got * torch.from_numpy(cot)).sum().backward()
    assert tuple(got.shape) == (4, out_w)
    _close(got.detach(), want)
    top = float(np.abs(np.asarray(want_gx)).max())
    assert np.abs(xt.grad.numpy() - np.asarray(want_gx)).max() <= \
        GRAD_REL * top
    if params:
        _close_grads(_port_grads(model), want_g)


# -- GraphModel and GraphEstimator --------------------------------------------

# the four mutag runners: (conv, pool, dim, layers)
RUNNERS = {"gin": ("gin", "sum", 8, 2), "graphgcn": ("gcn", "sum", 8, 4),
           "gated_graph": ("gated", "attention", 8, 2),
           "set2set": ("gin", "set2set", 8, 2)}


def _estimators(conv, pool, dim, layers, num_graphs=4, seed=5, data=None):
    """The reference's and the port's GraphModel / GraphEstimator over
    mutag_like(24) (dropout 0.5, which neither applies without a
    dropout stream / in eval mode)."""
    data = data or mutag_like(num_graphs=24)
    params = dict(num_graphs=num_graphs, seed=seed,
                  train_indices=data.train_indices,
                  eval_indices=data.eval_indices)
    jm = JGraphModel(conv, pool, dim, layers, num_graphs, 2, dropout=0.5)
    model = GraphModel(data.feature_dim, conv, pool, dim, layers, num_graphs,
                       2, dropout=0.5,
                       generator=torch.Generator().manual_seed(0))
    jest = JGraphEstimator(jm, params, data.graphs, data.labels)
    est = GraphEstimator(model, params, data.graphs, data.labels,
                         device="cpu")
    return jest, est


@pytest.mark.parametrize("runner", sorted(RUNNERS))
def test_graph_model_matches_the_reference(runner):
    """GraphModel in each mutag runner's configuration (narrowed to dim
    8) on a packed batch of 4 graphs whose last slot is padding
    (graph_mask 0): loss, accuracy, the graph embeddings and every
    gradient against the reference; the fresh port model has the
    reference's parameter tree."""
    conv, pool, dim, layers = RUNNERS[runner]
    jest, est = _estimators(conv, pool, dim, layers)
    data_idx = jest.params_cfg["eval_indices"]
    batch = jest._pack(np.asarray(data_idx[:4]), 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jest.model.init, compiler_options=_O0)(
        jax.random.key(0), jb)
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        est.model.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])

    def loss(p):
        out = jest.model.apply(p, jb)
        return out.loss, (out.metric, out.embedding)

    (want_l, (want_m, want_e)), want_g = jax.jit(
        jax.value_and_grad(loss, has_aux=True), compiler_options=_O0)(params)
    model = est.model
    model.load_state_dict(flax_to_state_dict(params))
    model.eval()
    out = model(_t(batch))
    out.loss.backward()
    assert out.metric_name == "acc"
    _close(out.loss.detach(), want_l)
    _close(out.metric, want_m)
    _close(out.embedding.detach(), want_e)
    _close_grads(_port_grads(model), want_g)


def test_graph_estimator_batches_match_the_reference():
    """Train batches (num_graphs drawn with replacement by the seeded
    numpy stream) and the eval sweep (the last chunk padded with its
    last graph under graph_mask 0) equal the reference's, array for
    array."""
    jest, est = _estimators("gin", "sum", 8, 2, num_graphs=2, seed=9)
    for jit_, it in ((jest.train_input_fn(), est.train_input_fn()),
                     (jest.eval_input_fn(), est.eval_input_fn())):
        n = 0
        for want, got in zip(jit_, it):
            assert sorted(got) == sorted(want)
            for k in want:
                a, b = np.asarray(got[k]), np.asarray(want[k])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
            n += 1
            if n == 6:
                break
    assert n == 3 == est.eval_steps()  # 5 eval graphs: 2 + 2 + 1
    assert est.max_nodes == jest.max_nodes and \
        est.max_edges == jest.max_edges


def test_evaluate_weights_each_batch_by_graph_mask():
    """An eval sweep of 5 graphs at 2 a batch (2 + 2 + 1, the last
    batch's second slot padding): the port's evaluate weights the
    batches 2 : 2 : 1 by graph_mask, as the reference does (loss and
    metric within rtol 1e-6 of the reference's evaluate with the same
    weights); weighting them 1 : 1 : 1 would give other numbers."""
    jest, est = _estimators("gin", "sum", 8, 2, num_graphs=2)
    want = jest.evaluate(jest.eval_input_fn, 5)
    est.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jest.state.params)))
    got = est.evaluate(est.eval_input_fn, 5)
    _close(got["loss"], want["loss"], rtol=1e-6, atol=0)
    _close(got["metric"], want["metric"], rtol=1e-6, atol=0)
    rows = []
    est.model.eval()
    with torch.no_grad():
        for b in est.eval_input_fn():
            out = est.model(_t(b))
            rows.append((float(out.loss), float(out.metric)))
    flat = np.mean(rows, axis=0)
    assert abs(flat[0] - got["loss"]) > 1e-4


@pytest.mark.parametrize("runner", ["run_gin", "run_graphgcn",
                                    "run_gated_graph", "run_set2set"])
def test_mutag_runner_runs_a_few_steps(runner, monkeypatch):
    """Each mutag runner for 12 steps (an eval every 10) with its
    defaults otherwise: finite, nothing skipped, an accuracy of the
    whole eval sweep (38 graphs: a multiple of 1/38); without --device
    it needs the card."""
    import importlib

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    res = mod.main(["--max_steps", "12", "--device", "cpu"])
    assert res["train_global_step"] == 12
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"]) and np.isfinite(res["eval_loss"])
    assert abs(res["eval_metric"] * 38 - round(res["eval_metric"] * 38)) \
        < 1e-6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--max_steps", "12"])
