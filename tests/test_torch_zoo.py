"""GAE, DGI and LGCN in the port against the JAX package, on the CPU:
BaseGraphGAE (plain, and VGAE with a given ε and with μ), GaeEstimator's
batches, DGI with a given corruption, LGCEncoder, the flax trees that
convert.py carries (Conv kernels, PReLU's slope, DGI's disc), and the
gae, dgi and lgcn runners.

Inputs are made with numpy from a seed; the reference's parameters are
carried into the port by euler_tpu_torch.convert. Tolerances (float32):
forward outputs rtol 1e-5 (atol 1e-6); gradients within 1e-5 of the
largest gradient of the tree; batches exact. The reference's programs
are jitted at XLA's lowest backend optimization level."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FullBatchDataFlow as JFullBatchDataFlow
from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth
from euler_tpu.estimator import GaeEstimator as JGaeEstimator
from euler_tpu.graph import seed as j_seed
from euler_tpu.models import DGI as JDGI
from euler_tpu.mp_utils import BaseGraphGAE as JBaseGraphGAE
from euler_tpu.utils.encoders import LGCEncoder as JLGCEncoder
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataflow import FullBatchDataFlow
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.estimators import GaeEstimator
from euler_tpu_torch.examples.run_gae import FlowAdapter
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.models.dgi import DGI
from euler_tpu_torch.mp_utils.base_gae import BaseGraphGAE
from euler_tpu_torch.utils.encoders import LGCEncoder
from euler_tpu_torch.utils.layers import PReLU

_O0 = {"xla_backend_optimization_level": 0}
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5
N, D = 14, 6


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


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ei = rng.integers(0, N, (2, 40)).astype(np.int32)
    return rng, x, ei


def _ref(jm, batch, rngs=None):
    """The reference's init, then (loss, metric, embedding) and the
    gradient of the loss, jitted."""
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0), batch)

    def loss(p):
        out = jm.apply(p, batch, rngs=rngs)
        return out.loss, (out.metric, out.embedding)

    (l_, (m, e)), g = jax.jit(jax.value_and_grad(loss, has_aux=True),
                              compiler_options=_O0)(params)
    return params, l_, m, e, g


def _check(model, params, batch, want_l, want_m, want_e, want_g):
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        model.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    model.load_state_dict(flax_to_state_dict(params))
    out = model({k: torch.from_numpy(np.asarray(v))
                 for k, v in batch.items()})
    out.loss.backward()
    assert out.metric_name == "auc"
    _close(out.loss.detach(), want_l)
    _close(out.metric, want_m)
    _close(out.embedding.detach(), want_e)
    _close_grads(_port_grads(model), want_g)


def _gae_batch(rng, x, ei):
    return {"x": x, "edge_index": ei,
            "root_index": np.arange(4, dtype=np.int32),
            "pos_src": ei[0, :10], "pos_dst": ei[1, :10],
            "neg_src": rng.integers(0, N, 10).astype(np.int32),
            "neg_dst": rng.integers(0, N, 10).astype(np.int32)}


@pytest.mark.parametrize("mode", ["plain", "vgae_eps", "vgae_mu"])
def test_gae_matches_the_reference(mode, monkeypatch):
    """BaseGraphGAE (two GCN layers of width 5) on a 14-node table with
    10 positive and 10 negative pairs: loss, AUC, the embeddings and
    every gradient against the reference. vgae_eps: the reference given
    a "sample" rng whose normal draw is replaced by a fixed ε, the port
    given that ε; vgae_mu: neither given one, so both embed with μ."""
    rng, x, ei = _graph(1)
    batch = _gae_batch(rng, x, ei)
    variational = mode != "plain"
    jm = JBaseGraphGAE(dim=5, variational=variational)
    rngs = None
    if mode == "vgae_eps":
        eps = rng.normal(size=(N, 5)).astype(np.float32)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape: jnp.asarray(eps))
        rngs = {"sample": jax.random.key(1)}
    params, *want = _ref(jm, {k: jnp.asarray(v) for k, v in batch.items()},
                         rngs)
    model = BaseGraphGAE(D, dim=5, variational=variational,
                         generator=torch.Generator().manual_seed(0))
    if mode == "vgae_eps":
        batch["eps"] = eps
    _check(model, params, batch, *want)


def test_gae_estimator_batches_match_the_reference():
    """GaeEstimator over FullBatchDataFlow on the same engine graph,
    engines seeded alike: every array of 4 batches (the table, the
    engine's roots, the positive columns and negative pairs of the
    seeded numpy stream) equal, exactly."""
    kw = dict(n=120, d=5, num_classes=3, seed=2)
    pg = engine_from_arrays(synthetic_citation(**kw)).engine
    jg = jsynth("t", **kw).engine
    params = dict(batch_size=8, num_pos=12, seed=3)
    jflow = JFullBatchDataFlow(jg, feature_ids=["feature"])

    def jadapter(roots):
        b = jflow(roots)
        b["n_real_nodes"] = b["nodes"].shape[0]
        return b

    jest = JGaeEstimator(JBaseGraphGAE(dim=4), params, jg, jadapter)
    est = GaeEstimator(BaseGraphGAE(5, dim=4), params, pg,
                       FlowAdapter(FullBatchDataFlow(
                           pg, feature_ids=["feature"])), device="cpu")
    j_seed(11)
    p_seed(11)
    for _, want, got in zip(range(4), jest.train_input_fn(),
                            est.train_input_fn()):
        assert sorted(got) == sorted(want)
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_dgi_matches_the_reference():
    """DGI (one GCN layer of width 7) with a given corruption (x's rows
    permuted): loss, AUC, the real rows' embeddings and every gradient
    (the encoder, PReLU's slope, disc) against the reference; a fresh
    port model has the reference's tree, PReLU's slope at flax's 0.01
    and disc within glorot-uniform's bound."""
    rng, x, ei = _graph(2)
    batch = {"x": x, "edge_index": ei,
             "x_corrupt": x[rng.permutation(N)]}
    params, *want = _ref(JDGI(dim=7), {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    model = DGI(D, dim=7, generator=torch.Generator().manual_seed(0))
    assert float(getattr(model, "PReLU_0").negative_slope.detach()) == \
        pytest.approx(0.01)
    assert float(model.disc.detach().abs().max()) <= (6.0 / 14) ** 0.5
    _check(model, params, batch, *want)
    assert float(torch.nn.PReLU().weight.detach()) == 0.25  # why PReLU is our own
    assert isinstance(getattr(model, "PReLU_0"), PReLU)


def test_lgc_encoder_matches_the_reference():
    """LGCEncoder (k 3, dim 5) over 6 roots with 4 neighbors each and
    ties among the neighbors' values: the output and the gradients of
    the Conv kernel and bias and of the roots' features against the
    reference; the fresh Conv weight has flax's [k+1, D, dim] tree."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, D)).astype(np.float32)
    nbr = rng.normal(size=(6, 4, D)).astype(np.float32)
    nbr[:, 1] = nbr[:, 3]
    jm = JLGCEncoder(dim=5, k=3)
    cot = rng.normal(size=(6, 5)).astype(np.float32)
    params = jax.jit(jm.init, compiler_options=_O0)(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(nbr))

    def loss(p, xx):
        out = jm.apply(p, xx, jnp.asarray(nbr))
        return (out * cot).sum(), out

    (_, want), (want_g, want_gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        compiler_options=_O0)(params, jnp.asarray(x))
    enc = LGCEncoder(D, 5, k=3, generator=torch.Generator().manual_seed(0))
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        enc.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    enc.load_state_dict(flax_to_state_dict(params))
    back = state_dict_to_flax(enc.state_dict())["conv"]["kernel"]
    np.testing.assert_array_equal(back, params["params"]["conv"]["kernel"])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = enc(xt, torch.from_numpy(nbr))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_grads(_port_grads(enc), want_g)
    top = float(np.abs(np.asarray(want_gx)).max())
    assert np.abs(xt.grad.numpy() - np.asarray(want_gx)).max() <= \
        GRAD_REL * top


@pytest.mark.parametrize("runner,argv,key", [
    ("run_gae", ["--max_steps", "6", "--eval_steps", "2"], "eval_metric"),
    ("run_gae", ["--max_steps", "6", "--eval_steps", "2", "--variational"],
     "eval_metric"),
    ("run_dgi", ["--max_steps", "4", "--eval_steps", "2", "--dim", "16"],
     "probe_acc"),
    ("run_lgcn", ["--max_steps", "6", "--fanout", "5", "--k", "3"],
     "test_metric")])
def test_zoo_runner_runs_a_few_steps(runner, argv, key, monkeypatch):
    """The gae (plain and --variational), dgi and lgcn runners for a few
    steps on a small stand-in (300 nodes, 16 features): finite, nothing
    skipped, a metric in [0, 1]; without --device they need the card."""
    import importlib

    from euler_tpu_torch.examples import common

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    monkeypatch.setattr(common, "get_dataset", lambda name: engine_from_arrays(
        synthetic_citation(n=300, d=16, num_classes=3, seed=1, val=60,
                           test=100)))
    res = mod.main([*argv, "--device", "cpu"])
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"])
    assert 0.0 <= res[key] <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
