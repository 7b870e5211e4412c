"""The gcn and genie encoders, the pool aggregators and the alias/fused
layouts through the models of the PyTorch port, against the JAX package
on the CPU: GCNEncoder and GenieEncoder (AttLayer, the OptimizedLSTMCell)
with converted flax params; DeviceSampledGraphSage's loss and gradients
for encoder x aggregator x layout on the reference's replayed uniforms;
DeviceSampledUnsupervisedSage over the fused and alias layouts and
DeviceSampledSkipGram over the alias layout, their loss and gradients."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.models.embedding_models import \
    DeviceSampledSkipGram as JaxSkipGram
from euler_tpu.models.graphsage import \
    DeviceSampledGraphSage as JaxDeviceSampledGraphSage
from euler_tpu.models.graphsage import \
    DeviceSampledUnsupervisedSage as JaxUnsupSage
from euler_tpu.parallel import device_sampler as J
from euler_tpu.utils import encoders as JE
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledUnsupervisedSage,
)
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.utils import encoders as PE

N, D, DIM, FANOUTS, CLASSES, B, NEGS = 60, 8, 8, (3, 2), 3, 8, 3

# the reference's programs compile at XLA's lowest backend optimization
# level: the same HLO, compiled in about half the time
_O0 = {"xla_backend_optimization_level": 0}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def graph():
    """A weighted graph (random edge weights, some zero) with float32
    features, its split tables with the alias words, and the reference's
    three layouts of the same tables."""
    g = synthetic_citation(n=N, d=D, num_classes=CLASSES, seed=6,
                           intra_degree=4.0, inter_degree=1.0)
    ws = np.random.default_rng(0).uniform(
        0.0, 3.0, g.neighbors.size).astype(np.float32)
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, ws, cap=4,
                                       device="cpu", keep_host=True,
                                       alias=True)
    feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, CLASSES), np.float32)])
    nbr, cum = tab.host_tables
    alias = tab.alias_table.numpy()
    port = {"split": {"nbr_table": tab.neighbors, "cum_table": tab.cum_weights},
            "fused": {"nbrcum_table": _t(J.fuse_tables_host(nbr, cum))}}
    port["alias"] = {**port["split"], "alias_table": tab.alias_table}
    ref = {k: {n: jnp.asarray(v.numpy()) for n, v in d.items()}
           for k, d in port.items()}
    common = {"feature_table": feats, "label_table": labels}
    return tab, port, ref, common


def _flax_params(module, jmodule, *args):
    """The port module's fresh parameters as the reference's flax tree,
    after checking that the reference's own init (traced, not run) has
    the same names and shapes."""
    params = state_dict_to_flax(module.state_dict())
    want = jax.eval_shape(jmodule.init, jax.random.key(0), *args)["params"]
    shapes = [{jax.tree_util.keystr(k): tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(t)[0]}
              for t in (want, params)]
    assert shapes[0] == shapes[1]
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _uniforms(key, n, counts, alias):
    """The reference's per-hop draws under `key`: split per hop, [n, k]
    each, or [2, n, k] for the alias draw."""
    out = []
    for k in counts:
        key, sub = jax.random.split(key)
        out.append(_t(jax.random.uniform(sub, (2, n, k) if alias else (n, k))))
        n *= k
    return out


@pytest.mark.parametrize("name", ["gcn", "genie"])
def test_fanout_encoders_match_flax(name):
    """GCNEncoder and GenieEncoder (its AttLayers, its LSTM as flax's
    OptimizedLSTMCell under nn.RNN) with the converted flax tree: within
    1e-5 of the largest output. GCN also takes the deepest hop as its
    neighbor mean."""
    rng = np.random.default_rng(1)
    layers = [rng.normal(size=(B * int(np.prod(FANOUTS[:h])), D))
              .astype(np.float32) for h in range(len(FANOUTS) + 1)]
    jcls, pcls = {"gcn": (JE.GCNEncoder, PE.GCNEncoder),
                  "genie": (JE.GenieEncoder, PE.GenieEncoder)}[name]
    j = jcls(DIM, FANOUTS)
    p = pcls(D, DIM, FANOUTS, generator=torch.Generator().manual_seed(1))
    params = _flax_params(p, j, layers)
    p.load_state_dict(flax_to_state_dict(params))
    want = np.asarray(jax.jit(j.apply, compiler_options=_O0)(params,
                                                             layers))
    with torch.no_grad():
        got = p([_t(x) for x in layers]).numpy()
        tol = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        if name == "gcn":
            last = _t(layers[-1]).view(-1, FANOUTS[-1], D).mean(1)
            got2 = p([_t(x) for x in layers[:-1]], nbr_mean=last,
                     nbr_count=FANOUTS[-1]).numpy()
            np.testing.assert_allclose(got2, want, rtol=0, atol=tol)
    back = state_dict_to_flax(p.state_dict())
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(params["params"]),
            jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb and np.asarray(a).tobytes() == b.tobytes()


# encoder, aggregator, layout: every encoder and aggregator, every layout
# (gcn's and genie's aggregator is unused)
_CASES = [("sage", "mean", "fused"), ("sage", "meanpool", "split"),
          ("sage", "maxpool", "alias"), ("gcn", "mean", "alias"),
          ("genie", "mean", "fused")]


@pytest.mark.parametrize("encoder,aggregator,layout", _CASES)
def test_graphsage_step_matches_the_reference(graph, encoder, aggregator,
                                              layout):
    """One training forward and backward of DeviceSampledGraphSage on
    the reference's uniforms: the loss within 1e-5 relative and every
    gradient within 1e-5 of the largest, after convert.py. The layout
    picks the draw as in the reference: a fused table the fused draw,
    an alias table the alias draw over uniform_sampling."""
    tab, port, ref, common = graph
    roots = np.random.default_rng(3).integers(0, N, B).astype(np.int32)
    seed = np.uint32(5)
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              **ref[layout], **common}
    jm = JaxDeviceSampledGraphSage(num_classes=CLASSES, multilabel=False,
                                   dim=DIM, fanouts=FANOUTS,
                                   aggregator=aggregator, encoder=encoder,
                                   uniform_sampling=True)
    model = DeviceSampledGraphSage(CLASSES, D, multilabel=False, dim=DIM,
                                   fanouts=FANOUTS, aggregator=aggregator,
                                   encoder=encoder, uniform_sampling=True,
                                   generator=torch.Generator().manual_seed(4))
    params = _flax_params(model, jm, jbatch)["params"]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jbatch).loss),
        compiler_options=_O0)(params)
    key = jax.random.fold_in(jax.random.key(17), seed)
    batch = {"rows": [_t(roots)], "sample_seed": int(seed),
             "sample_uniforms": _uniforms(key, B, FANOUTS,
                                          layout == "alias"),
             **port[layout], **{k: _t(v) for k, v in common.items()}}
    out = model(batch)
    out.loss.backward()
    assert float(out.loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = state_dict_to_flax({k: p.grad for k, p in
                              model.named_parameters()})
    want = jax.tree_util.tree_leaves(jgrads)
    tol = 1e-5 * max(float(np.abs(w).max()) for w in want)
    for w, g_ in zip(want, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g_, np.asarray(w), rtol=0, atol=tol)


def test_gcn_aggregator_in_sage_raises_as_the_reference():
    """The reference's SageEncoder passes concat to GCNAggregator, which
    has no such field: both packages raise TypeError."""
    jm = JE.SageEncoder(DIM, FANOUTS, "gcn")
    layers = [jnp.ones((B * int(np.prod(FANOUTS[:h])), D))
              for h in range(len(FANOUTS) + 1)]
    with pytest.raises(TypeError, match="concat"):
        jm.init(jax.random.key(0), layers)
    with pytest.raises(TypeError, match="concat"):
        DeviceSampledGraphSage(CLASSES, D, aggregator="gcn")
    with pytest.raises(ValueError, match="encoder"):
        DeviceSampledGraphSage(CLASSES, D, encoder="lstm")


def _grads_match(jmodel, jbatch, model, batch, static):
    """The reference's loss and gradients (jitted) at the port model's
    fresh parameters against the port's on the same draws: the loss
    within 1e-5 relative, every gradient within 1e-5 of the largest."""
    params = jax.tree_util.tree_map(
        jnp.asarray, state_dict_to_flax(model.state_dict()))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jbatch).loss),
        compiler_options=_O0)(params)
    out = model({**batch, **static})
    out.loss.backward()
    assert float(out.loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    got = state_dict_to_flax({k: p.grad for k, p in
                              model.named_parameters()})
    want = jax.tree_util.tree_leaves(jgrads)
    tol = 1e-5 * max(float(np.abs(w).max()) for w in want)
    for w, g_ in zip(want, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g_, np.asarray(w), rtol=0, atol=tol)


@pytest.mark.parametrize("layout", ["fused", "alias"])
def test_unsup_sage_step_over_fused_and_alias(graph, layout):
    """DeviceSampledUnsupervisedSage: the fanout, the positive (the
    fused draw sample_hop_fused(roots, 1), or the alias draw) and the
    negatives on the reference's three keys; the loss and gradients."""
    tab, port, ref, common = graph
    neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32), device="cpu")
    roots = np.random.default_rng(4).integers(0, N, B).astype(np.int32)
    seed = np.uint32(7)
    jneg = {"neg_rows": jnp.asarray(neg.rows.numpy()),
            "neg_cum": jnp.asarray(neg.cum.numpy())}
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              **ref[layout], **jneg, "feature_table": common["feature_table"]}
    model = DeviceSampledUnsupervisedSage(
        tab.pad_row, D, dim=DIM, fanouts=FANOUTS, num_negs=NEGS,
        generator=torch.Generator().manual_seed(0))
    jmodel = JaxUnsupSage(num_rows=tab.pad_row, dim=DIM, fanouts=FANOUTS,
                          num_negs=NEGS)
    kf, kp, kn = jax.random.split(
        jax.random.fold_in(jax.random.key(29), seed), 3)
    alias = layout == "alias"
    batch = {"rows": [_t(roots)], "sample_seed": int(seed),
             "sample_uniforms": _uniforms(kf, B, FANOUTS, alias),
             "pos_uniforms": _t(jax.random.uniform(
                 kp, (2, B, 1) if alias else (B, 1))),
             "neg_uniforms": _t(jax.random.uniform(kn, (B, NEGS)))}
    static = {**port[layout], **neg.tables,
              "feature_table": _t(common["feature_table"])}
    _grads_match(jmodel, jbatch, model, batch, static)


def test_skipgram_step_over_alias(graph):
    """DeviceSampledSkipGram (DeepWalk) with an alias table: every walk
    step takes the alias draw ([2, B] uniforms a step); the loss and
    gradients."""
    tab, port, ref, _ = graph
    neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32), device="cpu")
    roots = np.random.default_rng(5).integers(0, N, B).astype(np.int32)
    seed, walk_len = np.uint32(9), 3
    jbatch = {"rows": [jnp.asarray(roots)], "sample_seed": seed,
              **ref["alias"], "neg_rows": jnp.asarray(neg.rows.numpy()),
              "neg_cum": jnp.asarray(neg.cum.numpy())}
    model = DeviceSampledSkipGram(tab.pad_row, dim=DIM, walk_len=walk_len,
                                  num_negs=NEGS, uniform_sampling=True,
                                  generator=torch.Generator().manual_seed(0))
    jmodel = JaxSkipGram(num_rows=tab.pad_row, dim=DIM, walk_len=walk_len,
                         num_negs=NEGS, uniform_sampling=True)
    kw, kn = jax.random.split(jax.random.fold_in(jax.random.key(23), seed))
    walk_u = []
    for _ in range(walk_len):
        kw, sub = jax.random.split(kw)
        walk_u.append(_t(jax.random.uniform(sub, (2, B, 1))).reshape(2, B))
    pairs = B * 2 * walk_len
    batch = {"rows": [_t(roots)], "sample_seed": int(seed),
             "walk_uniforms": walk_u,
             "neg_uniforms": _t(jax.random.uniform(kn, (pairs, NEGS)))}
    _grads_match(jmodel, jbatch, model, batch,
                 {**port["alias"], **neg.tables})


@pytest.mark.parametrize("runner,extra", [
    ("run_geniepath", []),
    ("run_scalable_sage", ["--encoder", "gcn", "--fanout", "4"]),
    ("run_graphsage", ["--act_cache", "--fused_sampler", "--fanouts",
                       "4,2"]),
    ("run_graphsage", ["--aggregator", "maxpool", "--fused_sampler",
                       "--fanouts", "4,2", "--mode", "unsupervised"])])
def test_slice7_runners_run_a_few_steps_on_the_cpu(runner, extra,
                                                    monkeypatch):
    """Each new runner path for 10 steps on a small stand-in (300 nodes,
    16 features, the cora split's shape shrunk) in the engine: finite,
    nothing skipped; without --device_sampler the geniepath and scalable
    runners train host-fed for 10 steps too, where --encoder gcn exits
    and run_graphsage's --act_cache refuses, as the reference's do;
    without --device it needs the card."""
    import importlib

    from euler_tpu_torch.dataset import engine_from_arrays
    from euler_tpu_torch.examples import common

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    monkeypatch.setattr(common, "get_dataset", lambda name: engine_from_arrays(
        synthetic_citation(n=300, d=16, num_classes=3, seed=1, val=60,
                           test=100)))
    argv = ["--device_sampler", "--max_steps", "10", "--eval_steps", "2",
            *extra]
    if runner == "run_geniepath":
        argv += ["--fanouts", "4,2"]
    res = mod.main([*argv, "--device", "cpu"])
    assert res["train_global_step"] == 10
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"])
    if "--mode" not in extra:
        assert 0.0 <= res["test_metric"] <= 1.0
    if runner != "run_graphsage":
        host = [a for a in argv if a != "--device_sampler"]
        if "gcn" in extra:
            with pytest.raises(SystemExit, match="requires --device_sampler"):
                mod.main([*host, "--device", "cpu"])
            host = [a for a in host if a not in ("--encoder", "gcn")]
        res = mod.main([*host, "--device", "cpu"])
        assert res["train_global_step"] == 10
        assert res["train_skipped_steps"] == 0
        assert np.isfinite(res["train_loss"])
        assert 0.0 <= res["test_metric"] <= 1.0
    elif "--act_cache" in extra:
        with pytest.raises(SystemExit, match="needs --device_sampler"):
            mod.main(["--device", "cpu", "--act_cache"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
