"""The walk family of the PyTorch port against the JAX package, on the
CPU: Embedding, the MRR metrics and the sigmoid BCE, the node sampler
and the device walks (euler_tpu/parallel/device_walk.py) with replayed
uniforms, skip-gram pair order, DeviceSampledSkipGram (DeepWalk,
node2vec, LINE) after convert.py, and the DeepWalk and LINE runners."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.estimator.base_estimator import \
    BaseEstimator as JaxBaseEstimator
from euler_tpu.estimator.base_estimator import TrainState as JaxTrainState
from euler_tpu.models.embedding_models import \
    DeviceSampledSkipGram as JaxSkipGram
from euler_tpu.parallel import device_sampler as JS
from euler_tpu.parallel import device_walk as JW
from euler_tpu.utils import layers as JL
from euler_tpu.utils import metrics as JM
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
from euler_tpu_torch.parallel import device_walk as PW
from euler_tpu_torch.parallel.device_sampler import (
    DeviceNeighborTable, build_alias_tables, fuse_tables_host, slot_weights,
)
from euler_tpu_torch.utils import metrics as PM
from euler_tpu_torch.utils.layers import Embedding
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy

N, C, B, DIM, NEGS, LR = 50, 4, 16, 8, 5, 0.01

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time
_O0 = {"xla_backend_optimization_level": 0}


def _t(x):
    return torch.from_numpy(np.array(x))


def _graph():
    """50 nodes, 4 of them isolated (dead ends), 8 above the cap of 4."""
    return synthetic_citation(n=N, d=4, num_classes=3, seed=0,
                              intra_degree=2.0, inter_degree=1.0)


def _tables(weighted=False):
    g = _graph()
    ws = None
    if weighted:
        ws = np.random.default_rng(1).uniform(
            0.1, 5.0, g.neighbors.size).astype(np.float32)
    return DeviceNeighborTable.from_csr(g.offsets, g.neighbors, ws, cap=C,
                                        device="cpu", keep_host=True)


def _roots(seed=3):
    return np.random.default_rng(seed).integers(0, N, B).astype(np.int32)


# -- layers, metrics, loss ---------------------------------------------------

def test_embedding_init_and_lookup_match_flax():
    """Fresh init has flax's distribution, U[0, 0.05) (draws differ, and
    repeat from the generator); with the flax table converted, the
    lookup of ids outside [0, rows) wraps by floor mod as
    bucketize_ids does, and equals flax's exactly."""
    rows, dim = 1000, 16
    ref = JL.Embedding(rows, dim)
    params = ref.init(jax.random.key(0), jnp.zeros((1,), jnp.int32))
    table = np.asarray(params["params"]["table"])
    port = Embedding(rows, dim, generator=torch.Generator().manual_seed(0))
    got = port.table.detach().numpy()
    for t in (table, got):
        assert t.min() >= 0.0 and t.max() < 0.05
        assert abs(float(t.mean()) - 0.025) < 5e-4
        assert abs(float(t.std()) - 0.05 / np.sqrt(12)) < 5e-4
    again = Embedding(rows, dim, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.table, port.table)
    port.load_state_dict(flax_to_state_dict(params))
    ids = np.random.default_rng(0).integers(-2500, 3500, 64).astype(np.int32)
    want = np.asarray(ref.apply(params, jnp.asarray(ids)))
    with torch.no_grad():
        np.testing.assert_array_equal(port(_t(ids)).numpy(), want)


def test_ranks_and_mrr_count_ties_against_the_positive():
    scores = np.array([[1.0, 1.0, 0.5, 2.0], [0.3, 0.1, 0.2, 0.0],
                       [0.0, 0.0, 0.0, 0.0], [-1.0, 3.0, -1.0, -2.0]],
                      np.float32)
    j, p = jnp.asarray(scores), _t(scores)
    np.testing.assert_array_equal(PM._ranks(p).numpy(),
                                  np.asarray(JM._ranks(j)))
    assert PM._ranks(p).tolist() == [3.0, 1.0, 4.0, 3.0]
    for got, want in ((PM.mrr(p), JM.mrr(j)), (PM.mr(p), JM.mr(j)),
                      (PM.hit_at_k(p, 1), JM.hit_at_k(j, 1)),
                      (PM.hit_at_k(p, 3), JM.hit_at_k(j, 3))):
        assert float(got) == pytest.approx(float(want), rel=1e-7)
    mask = _t(np.array([1, 0, 1, 1], np.float32))
    assert float(PM.mrr(p, mask)) == pytest.approx(
        (1 / 3 + 1 / 4 + 1 / 3) / 3, rel=1e-7)


def test_sigmoid_bce_matches_optax_at_large_logits():
    """Within 1e-6 relative (1e-7 absolute) of optax's, |x| up to 1e30:
    a large |x| gives |x| or 0, never inf or NaN."""
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [-1e30, -1e4, -90.0, 90.0, 1e4, 1e30]]).astype(
                            np.float32)
    for y in (0.0, 1.0, 0.3):
        labels = np.full_like(x, y)
        want = np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(x), jnp.asarray(labels)))
        got = sigmoid_binary_cross_entropy(_t(x), _t(labels)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- the node sampler and the walks ------------------------------------------

def test_slot_weights_invert_the_cumsum():
    cum = _tables(weighted=True).host_tables[1]
    np.testing.assert_array_equal(slot_weights(_t(cum)).numpy(),
                                  np.asarray(JS.slot_weights(
                                      jnp.asarray(cum))))


class _Graph:
    """The three engine calls the reference's DeviceNodeSampler makes."""

    def __init__(self, types, weights):
        self.types, self.weights = types, weights

    def all_node_ids(self):
        return np.arange(len(self.types), dtype=np.uint64)

    def get_node_type(self, ids):
        return self.types[ids.astype(np.int64)]

    def all_node_weights(self):
        return self.weights


@pytest.mark.parametrize("node_type", [-1, 1])
def test_node_sampler_tables_and_draws_match_the_reference(node_type):
    """Pool and cumsum byte-identical to the reference's from the same
    weights and types; sample_global_rows picks the same rows from the
    reference's uniforms, zero-weight nodes never."""
    rng = np.random.default_rng(2)
    types = rng.integers(0, 3, N).astype(np.int32)
    w = rng.uniform(0.0, 3.0, N).astype(np.float32)
    w[::7] = 0.0
    ref = JW.DeviceNodeSampler(_Graph(types, w), node_type=node_type)
    got = PW.DeviceNodeSampler.from_arrays(w, types, node_type,
                                           device="cpu")
    for k, v in got.tables.items():
        assert v.numpy().tobytes() == np.asarray(ref.tables[k]).tobytes(), k
    key = jax.random.key(5)
    want = np.asarray(jax.jit(
        lambda r, c, k: JW.sample_global_rows(r, c, k, (B, 7)),
        compiler_options=_O0)(ref.rows, ref.cum, key))
    u = _t(jax.random.uniform(key, (B, 7)))
    rows = PW.sample_global_rows(got.rows, got.cum, (B, 7), uniforms=u)
    np.testing.assert_array_equal(rows.numpy(), want)
    assert not np.isin(rows.numpy(), np.flatnonzero(w == 0)).any()


def test_node_sampler_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PW.DeviceNodeSampler.from_arrays(np.ones(4, np.float32))


def _walk_uniforms(key, walk_len):
    """The reference walk's per-step uniforms: one split per step."""
    out = []
    for _ in range(walk_len):
        key, sub = jax.random.split(key)
        out.append(_t(jax.random.uniform(sub, (B,))))
    return out


@pytest.mark.parametrize("case", ["weighted", "uniform", "node2vec"])
def test_walk_rows_bit_exact_with_replayed_uniforms(case):
    """walk_rows against the reference's on the same tables and the
    reference's uniforms, pick for pick: the weighted inverse-CDF draw,
    the unit-weight draw, and node2vec's biased draw (p = 0.5, q = 2 on
    unit slots: every biased row sums exactly in float32 in any order,
    so the two cumsums agree at every boundary). Walks reach the pad
    row at the graph's dead ends and stay there."""
    tab = _tables(weighted=case == "weighted")
    nbr, cum = tab.host_tables
    p, q = (0.5, 2.0) if case == "node2vec" else (1.0, 1.0)
    uniform = case == "uniform"
    assert tab.uniform_rows == (case != "weighted")
    roots, L = _roots(), 6
    key = jax.random.key(11)
    want = np.asarray(jax.jit(
        lambda n, c, r, k: JW.walk_rows(n, c, r, L, k, p=p, q=q,
                                        uniform=uniform),
        compiler_options=_O0)(nbr, cum, roots, key))
    got = PW.walk_rows(tab.neighbors, tab.cum_weights, _t(roots), L,
                       uniforms=_walk_uniforms(key, L), p=p, q=q,
                       uniform=uniform)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == tab.pad_row).any()
    gen = torch.Generator().manual_seed(0)
    drawn = PW.walk_rows(tab.neighbors, tab.cum_weights, _t(roots), L,
                         generator=gen, p=p, q=q, uniform=uniform)
    assert drawn.shape == (B, L + 1) and torch.equal(drawn[:, 0], _t(roots))


@pytest.mark.parametrize("cols,left,right", [(6, 1, 1), (2, 0, 1), (5, 2, 1),
                                             (1, 1, 1)])
def test_pair_order_matches_the_reference(cols, left, right):
    walks = np.arange(B * cols, dtype=np.int32).reshape(B, cols)
    assert PW.gen_pair_offsets(cols, left, right) == \
        list(JW.gen_pair_offsets(cols, left, right))
    want = np.asarray(JW.gen_pair_rows(jnp.asarray(walks), left, right))
    got = PW.gen_pair_rows(_t(walks), left, right)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- DeviceSampledSkipGram ---------------------------------------------------

_CONFIGS = {
    # DeepWalk as bench.py --walk draws it: unit tables, one-gather steps
    "deepwalk": (dict(walk_len=4, left_win=1, right_win=1,
                      uniform_sampling=True), False),
    "node2vec": (dict(walk_len=4, left_win=1, right_win=2, p=0.5, q=2.0),
                 False),
    "line_first": (dict(walk_len=1, left_win=0, right_win=1,
                        share_context=True), True),
    "line_second": (dict(walk_len=1, left_win=0, right_win=1), True),
}


def _replayed(seed, walk_len, pairs):
    """The reference's draws for sample_seed: fold_in(key(23), seed)
    split into the walk's key and the negatives' key."""
    kw, kn = jax.random.split(jax.random.fold_in(jax.random.key(23), seed))
    return {"walk_uniforms": _walk_uniforms(kw, walk_len),
            "neg_uniforms": _t(jax.random.uniform(kn, (pairs, NEGS)))}


def _reference_estimator(jmodel, model, jbatch):
    """The reference estimator (Adam at LR) over the port model's fresh
    parameters, converted: the reference's own init tree (traced, not
    run) has the same names and shapes."""
    jest = JaxBaseEstimator(jmodel, {"optimizer": "adam",
                                     "learning_rate": LR})
    params = state_dict_to_flax(model.state_dict())
    want = jax.eval_shape(jmodel.init, jax.random.key(0), jbatch)["params"]
    shapes = [{jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(t)[0]}
              for t in (want, params)]
    assert shapes[0] == shapes[1]
    jest.state = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
        tx=jest.tx, extra_vars={}, skipped_steps=jnp.zeros((), jnp.int32))
    return jest


def _tie_bound(model, batch) -> float:
    """How far the MRR may move by rounding: the share of valid pairs
    with a negative whose logit is within 1e-6 (relative) of the
    positive's. Most such pairs drew the positive's own node as a
    negative: its two logits are equal in exact arithmetic, and whether
    it ranks above the positive depends on the order each package sums
    in (the reference computes the positive's logit and the negatives'
    in two different ops). Each such pair moves the MRR by less than
    1 / the valid pairs; every other pair ranks the same."""
    with torch.no_grad():
        pairs, negs = model.sample(batch)
        table = model.emb if model.ctx is None else model.ctx
        src = model.emb(pairs[:, 0])
        ctx = table(torch.cat([pairs[:, 1:], negs], 1))
        s = torch.einsum("bd,bkd->bk", src, ctx)
    valid = (pairs != model.num_rows).all(1)
    near = ((s[:, 1:] - s[:, :1]).abs()
            <= 1e-6 * s.abs().max()).any(1) & valid
    return float(near.sum()) / max(float(valid.sum()), 1.0) + 1e-6


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_skipgram_matches_the_reference(name):
    """After convert.py, on the reference's uniforms: the same parameter
    names and shapes, loss within 1e-5 relative, MRR within its rounding
    ties (_tie_bound), the embedding exact, and one Adam step's
    parameters within 1e-5 of the largest parameter (the dense gradient
    of every table row, as optax's). DeepWalk's walks reach dead ends,
    so its pad mask is exercised."""
    kw, weighted = _CONFIGS[name]
    tab = _tables(weighted)
    neg = PW.DeviceNodeSampler.from_arrays(np.ones(N, np.float32),
                                           device="cpu")
    nbr, cum = tab.host_tables
    roots, seed = _roots(4), np.uint32(9)
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              "nbr_table": jnp.asarray(nbr), "cum_table": jnp.asarray(cum),
              "neg_rows": jnp.asarray(neg.rows.numpy()),
              "neg_cum": jnp.asarray(neg.cum.numpy())}
    model = DeviceSampledSkipGram(tab.pad_row, dim=DIM, num_negs=NEGS,
                                  generator=torch.Generator().manual_seed(0),
                                  **kw)
    jest = _reference_estimator(
        JaxSkipGram(num_rows=tab.pad_row, dim=DIM, num_negs=NEGS, **kw),
        model, jbatch)
    pairs = B * len(PW.gen_pair_offsets(kw["walk_len"] + 1, kw["left_win"],
                                        kw["right_win"]))
    batch = {"rows": [_t(roots)], "sample_seed": int(seed),
             **_replayed(seed, kw["walk_len"], pairs)}
    static = {**tab.tables, **neg.tables}
    emb_table = np.asarray(jest.state.params["emb"]["table"])
    # the reference's step returns the loss and metric before its update
    state, jloss, jmetric = jax.jit(jest._make_one_step(),
                                    compiler_options=_O0)(jest.state,
                                                             jbatch)
    with torch.no_grad():
        out = model({**batch, **static})
        got_pairs, _ = model.sample({**batch, **static})
    if name == "deepwalk":
        assert (got_pairs == tab.pad_row).any()
    assert float(out.loss) == pytest.approx(float(jloss), rel=1e-5)
    assert abs(float(out.metric) - float(jmetric)) <= _tie_bound(
        model, {**batch, **static})
    np.testing.assert_array_equal(out.embedding.numpy(), emb_table[roots])
    est = BaseEstimator(model, {"optimizer": "adam", "learning_rate": LR,
                                "checkpoint_steps": 0}, device="cpu")
    est.static_batch = static
    res = est.train(iter([batch]), max_steps=1)
    assert res["loss"] == float(out.loss)
    want = jax.tree_util.tree_leaves(state.params)
    got = jax.tree_util.tree_leaves(state_dict_to_flax(model.state_dict()))
    tol = 1e-5 * max(float(np.abs(w).max()) for w in want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol)


def test_skipgram_refuses_fused_and_alias_tables():
    """The skip-gram takes the alias draw now
    (tests/test_torch_encoders.py holds it against the reference). Its
    walk reads the split tables: a batch with the fused table alone
    raises KeyError, as the reference's does."""
    tab = _tables()
    neg = PW.DeviceNodeSampler.from_arrays(np.ones(N, np.float32),
                                           device="cpu")
    model = DeviceSampledSkipGram(tab.pad_row, dim=DIM)
    alias = torch.from_numpy(
        build_alias_tables(tab.neighbors.numpy(),
                           cum_tab=tab.cum_weights.numpy()))
    out = model({"rows": [_t(_roots())], "sample_seed": 1, **tab.tables,
                 **neg.tables, "alias_table": alias})
    assert torch.isfinite(out.loss)
    fused = torch.from_numpy(fuse_tables_host(tab.neighbors.numpy(),
                                              tab.cum_weights.numpy()))
    with pytest.raises(KeyError, match="nbr_table"):
        model({"rows": [_t(_roots())], "sample_seed": 1,
               "nbrcum_table": fused, **neg.tables})


# -- the runners --------------------------------------------------------------

@pytest.mark.parametrize("runner,extra", [
    ("run_deepwalk", ["--steps_per_loop", "4"]),
    ("run_deepwalk", ["--p", "0.5", "--q", "2"]),
    ("run_line", ["--order", "1"]),
    ("run_line", [])])
def test_walk_runners_run_a_few_steps_on_the_cpu(runner, extra):
    """Each runner's --device_sampler path and its host-fed path (the
    engine's walks or edges) for 12 steps and 2 evaluation batches on
    the cora stand-in: finite, nothing skipped, the MRR in (0, 1]."""
    import importlib

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    for path in (["--device_sampler"], []):
        res = mod.main([*path, "--device", "cpu", "--max_steps", "12",
                        "--eval_steps", "2", *extra])
        assert res["train_global_step"] == 12
        assert res["train_skipped_steps"] == 0 \
            and res["train_skipped_batches"] == 0
        assert np.isfinite(res["train_loss"]) \
            and np.isfinite(res["eval_loss"])
        assert 0.0 < res["eval_metric"] <= 1.0


@pytest.mark.parametrize("runner,extra", [
    ("run_deepwalk", []), ("run_line", []),
    ("run_graphsage", ["--mode", "unsupervised"])])
def test_unsupervised_runners_need_cuda_by_default(runner, extra,
                                                   monkeypatch):
    """Without --device the runners run on the card, and raise on a
    machine without one."""
    import importlib

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--device_sampler", "--max_steps", "1", *extra])
