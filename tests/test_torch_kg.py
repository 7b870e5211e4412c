"""The relational and knowledge-graph family in the port against the
JAX package, on the CPU: the kg_sets copy (triples, engines and the
data-dir branch), the five KG scorers (with a triple whose h + r - t has
an exactly zero component, where the L1 norm's gradient is the
reference's +1), the R-GCN runner's model, RelationConv alone and inside
BaseGNNNet, RelationDataFlow and Block, GroupGNNNet and
SharedGroupGNNNet, and the TransX and R-GCN runners' batches.

Inputs are made with numpy from a seed; the reference's parameters are
carried into the port by euler_tpu_torch.convert. Tolerances (float32):
forward outputs rtol 1e-5 (atol 1e-6); gradients within 1e-5 of the
largest gradient of the tree; batches and triples exact. The
reference's programs are jitted at XLA's lowest backend optimization
level."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu import models as JM
from euler_tpu.convolution import RelationConv as JRelationConv
from euler_tpu.dataflow import Block as JBlock
from euler_tpu.dataflow import RelationDataFlow as JRelationDataFlow
from euler_tpu.dataset import kg_sets as JK
from euler_tpu.estimator.base_estimator import BaseEstimator as JBase
from euler_tpu.graph import GraphBuilder as JGraphBuilder
from euler_tpu.graph import seed as j_seed
from euler_tpu.mp_utils.base import ModelOutput as JModelOutput
from euler_tpu.mp_utils.base_gnn import BaseGNNNet as JBaseGNNNet
from euler_tpu.mp_utils.group_gnn import GroupGNNNet as JGroupGNNNet
from euler_tpu.utils import metrics as JMet
from euler_tpu.utils.layers import Embedding as JEmbedding
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.convolution import RelationConv
from euler_tpu_torch.dataflow import Block, RelationDataFlow
from euler_tpu_torch.dataset import kg_sets as PK
from euler_tpu_torch.examples.run_rgcn import RGCNLinkModel, rgcn_input_fn
from euler_tpu_torch.examples.run_transx import triple_input_fn
from euler_tpu_torch.graph import GraphBuilder
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.models import kg_models as PM
from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet
from euler_tpu_torch.mp_utils.group_gnn import (
    GroupGNNNet, SharedGroupGNNNet,
)

ROOT = Path(__file__).resolve().parents[1]
_O0 = {"xla_backend_optimization_level": 0}
RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-5
ENT, REL, DIM = 16, 5, 4


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


def _port_grads(module):
    return {"params": state_dict_to_flax(
        {k: p.grad for k, p in module.named_parameters()})}


def _ref(jm, args, loss_of, params=None):
    """The reference's init (or the given params), then loss_of(output),
    the output (a ModelOutput as (metric, embedding)) and the gradient,
    jitted."""
    if params is None:
        params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0),
                                                        *args)

    def f(p):
        out = jm.apply(p, *args)
        if isinstance(out, JModelOutput):
            return out.loss, (out.metric, out.embedding)
        return loss_of(out), out

    (val, out), g = jax.jit(jax.value_and_grad(f, has_aux=True),
                            compiler_options=_O0)(params)
    return params, val, out, g


def _load(module, params):
    fresh = jax.tree_util.tree_map(np.shape, state_dict_to_flax(
        module.state_dict()))
    assert fresh == jax.tree_util.tree_map(np.shape, params["params"])
    module.load_state_dict(flax_to_state_dict(params))


# -- kg_sets ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JK._SHAPES))
def test_kg_sets_copy_matches_the_original(name):
    """_SHAPES equal; _synthetic_triples array for array at seeds 0 and
    1 (300 triples of the dataset's shape); load_kg's engines, seeded
    alike, give the same sample_edge draws."""
    assert PK._SHAPES == JK._SHAPES
    shape = JK._SHAPES[name]
    for seed in (0, 1):
        np.testing.assert_array_equal(
            PK._synthetic_triples(**shape, num_triples=300, seed=seed),
            JK._synthetic_triples(**shape, num_triples=300, seed=seed))
    pk, jk = PK.load_kg(name, 300), JK.load_kg(name, 300)
    assert (pk.num_entities, pk.num_relations, pk.name, pk.source) == \
        (jk.num_entities, jk.num_relations, jk.name, jk.source)
    assert (pk.engine.node_count, pk.engine.edge_count) == \
        (jk.engine.node_count, jk.engine.edge_count)
    p_seed(4)
    j_seed(4)
    for a, b in zip(pk.engine.sample_edge(64, -1),
                    jk.engine.sample_edge(64, -1)):
        np.testing.assert_array_equal(a, b)


def test_load_kg_reads_the_data_dir(tmp_path, monkeypatch):
    """A wn18/train.txt under $EULER_TPU_DATA_DIR (names numbered in
    order of first appearance, a malformed line skipped): the same
    sizes, source and typed neighbor draws in both packages."""
    d = tmp_path / "wn18"
    d.mkdir()
    (d / "train.txt").write_text(
        "a likes b\nb likes c\nbad line here too\nc hates a\na hates c\n")
    monkeypatch.setenv("EULER_TPU_DATA_DIR", str(tmp_path))
    pk, jk = PK.load_kg("wn18"), JK.load_kg("wn18")
    assert (pk.num_entities, pk.num_relations, pk.source) == \
        (jk.num_entities, jk.num_relations, jk.source) == \
        (3, 2, str(d / "train.txt"))
    ids = np.arange(3, dtype=np.uint64)
    p_seed(2)
    j_seed(2)
    for r in (0, 1):
        got = pk.engine.sample_neighbor(ids, 4, edge_types=[r])
        want = jk.engine.sample_neighbor(ids, 4, edge_types=[r])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# -- the scorers --------------------------------------------------------------

def _kg_batch(rng, b=6, n=5):
    return {"h": rng.integers(0, ENT, b).astype(np.int64),
            "t": rng.integers(0, ENT, b).astype(np.int64),
            "r": rng.integers(0, REL, b).astype(np.int32),
            "neg_t": rng.integers(0, ENT, (b, n)).astype(np.int64)}


@pytest.mark.parametrize("name", ["TransE", "TransH", "TransR", "TransD",
                                  "DistMult"])
def test_kg_scorer_matches_the_reference(name):
    """Each scorer (16 entities, 5 relations, width 4, margin 1) on 6
    triples with 5 corrupted tails each: loss, MRR, the head embeddings
    and every gradient. TransE's first triple has h + r - t exactly 0 in
    its first three components (t's row set to fl(h + r) there), where
    the reference's L1 gradient is +1 and torch's abs gives 0."""
    rng = np.random.default_rng(0)
    batch = _kg_batch(rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = getattr(JM, name)(num_entities=ENT, num_relations=REL, dim=DIM)
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0), jb)
    if name == "TransE":
        p = jax.tree_util.tree_map(np.array, params)
        h, t, r = batch["h"][0], batch["t"][0], batch["r"][0]
        batch["t"][1:][batch["t"][1:] == t] = (t + 1) % ENT
        batch["neg_t"][batch["neg_t"] == t] = (t + 1) % ENT
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ent, rel = p["params"]["ent"]["table"], p["params"]["rel"]["table"]
        ent[t, :3] = (ent[h, :3] + rel[r, :3]).astype(np.float32)
        params = jax.tree_util.tree_map(jnp.asarray, p)
        diff = ent[h] + rel[r] - ent[t]
        assert (diff[:3] == 0).all()
    _, want_l, (want_m, want_e), want_g = _ref(jm, (jb,), None, params)
    model = getattr(PM, name)(ENT, REL, dim=DIM)
    _load(model, params)
    got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    got.loss.backward()
    assert got.metric_name == "mrr"
    _close(got.loss.detach(), want_l)
    _close(got.metric, want_m)
    _close(got.embedding.detach(), want_e)
    _close_grads(_port_grads(model), want_g)
    if name == "TransE":
        # the zero components' gradient is the reference's, not abs's 0
        g = np.asarray(want_g["params"]["ent"]["table"])
        assert np.abs(g[batch["h"][0], :3]).min() > 0


class _JRGCNLinkModel(fnn.Module):
    """The reference runner's RGCNLinkModel
    (examples/rgcn/run_rgcn.py:50-77), its closure's sizes as fields."""

    num_entities: int
    num_relations: int
    dim: int
    num_rel_sample: int

    @fnn.compact
    def __call__(self, batch):
        R = self.num_rel_sample
        ent = JEmbedding(self.num_entities, self.dim, name="ent")
        rel = JEmbedding(self.num_relations, self.dim, name="rel")
        w_rel = self.param("w_rel", fnn.initializers.glorot_uniform(),
                           (R, self.dim, self.dim))

        def encode(ids, nbr_ids):
            h = ent(ids)
            nbr = ent(nbr_ids).mean(axis=2)
            msg = jnp.einsum("rbd,rde->be", nbr, w_rel) / R
            return fnn.relu(h + msg)

        h = encode(batch["h"], batch["h_nbrs"])
        t = ent(batch["t"])
        neg_t = ent(batch["neg_t"])
        r = rel(batch["r"])
        pos = (h * r * t).sum(-1, keepdims=True)
        neg = jnp.einsum("bd,bnd->bn", h * r, neg_t)
        loss = jnp.maximum(0.0, 1.0 - pos + neg).mean()
        scores = jnp.concatenate([pos, neg], axis=1)
        return JModelOutput(h, loss, "mrr", JMet.mrr(scores))


def test_rgcn_link_model_matches_the_reference():
    """RGCNLinkModel (3 sampled relations, fanout 2) on 6 triples: loss,
    MRR, the encoded heads and every gradient; a fresh w_rel lies within
    flax's glorot bound for a [R, dim, dim] weight (fans R·dim)."""
    rng = np.random.default_rng(1)
    batch = {**_kg_batch(rng),
             "h_nbrs": rng.integers(0, ENT, (3, 6, 2)).astype(np.int64)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, want_l, (want_m, want_e), want_g = _ref(
        _JRGCNLinkModel(ENT, REL, DIM, 3), (jb,), None)
    model = RGCNLinkModel(ENT, REL, DIM, 3,
                          generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (2 * 3 * DIM))
    top = float(model.w_rel.detach().abs().max())
    assert 0.7 * limit < top <= limit
    _load(model, params)
    got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    got.loss.backward()
    _close(got.loss.detach(), want_l)
    _close(got.metric, want_m)
    _close(got.embedding.detach(), want_e)
    _close_grads(_port_grads(model), want_g)


# -- RelationConv, RelationDataFlow, GroupGNNNet ------------------------------

def _graph(rng, n=11, e=40):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    et = rng.integers(0, 3, e).astype(np.int32)
    return x, ei, et


@pytest.mark.parametrize("typed", [True, False])
def test_relation_conv_matches_the_reference(typed):
    """RelationConv (3 relations, 5 → 4) on an 11-node graph of 40
    edges, with edge types or without (all relation 0): the output and
    the gradients of w_rel and lin_root; a fresh w_rel is glorot with
    flax's fans."""
    rng = np.random.default_rng(2)
    x, ei, et = _graph(rng)
    cot = rng.normal(size=(11, 4)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(ei),
            jnp.asarray(et) if typed else None)
    params, _, want, want_g = _ref(
        JRelationConv(out_dim=4, num_relations=3), args,
        lambda o: (o * cot).sum())
    conv = RelationConv(5, 4, 3, generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (3 * (5 + 4)))
    assert float(conv.w_rel.detach().abs().max()) <= limit
    _load(conv, params)
    got = conv(torch.from_numpy(x), torch.from_numpy(ei),
               torch.from_numpy(et) if typed else None)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_grads(_port_grads(conv), want_g)


def test_relation_conv_in_base_gnn_matches_the_reference():
    """BaseGNNNet("relation", two layers of width 4, num_relations 3)
    passes the batch's edge_type to each RelationConv_{i}: the root
    rows and every gradient."""
    rng = np.random.default_rng(3)
    x, ei, et = _graph(rng)
    batch = {"x": x, "edge_index": ei, "edge_type": et,
             "root_index": np.array([0, 3, 3, 7], np.int32)}
    cot = rng.normal(size=(4, 4)).astype(np.float32)
    kw = {"num_relations": 3}
    params, _, want, want_g = _ref(
        JBaseGNNNet("relation", 4, 2, conv_kwargs=kw),
        ({k: jnp.asarray(v) for k, v in batch.items()},),
        lambda o: (o * cot).sum())
    net = BaseGNNNet("relation", 5, 4, 2, conv_kwargs=kw)
    _load(net, params)
    got = net({k: torch.from_numpy(v) for k, v in batch.items()})
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_grads(_port_grads(net), want_g)


def _typed_graph(builder_cls):
    """12 nodes with a 3-wide dense feature and 30 edges of 3 types."""
    rng = np.random.default_rng(7)
    b = builder_cls()
    b.set_num_types(1, 3)
    b.set_feature(0, 0, 3, "feature")
    ids = np.arange(12, dtype=np.uint64)
    b.add_nodes(ids)
    b.add_edges(rng.integers(0, 12, 30).astype(np.uint64),
                rng.integers(0, 12, 30).astype(np.uint64),
                types=rng.integers(0, 3, 30).astype(np.int32))
    b.set_node_dense(ids, 0, rng.normal(size=(12, 3)).astype(np.float32))
    return b.finalize()


@pytest.mark.parametrize("features", [True, False])
def test_relation_dataflow_and_block_match_the_reference(features):
    """RelationDataFlow (fanout 3 over 3 relations) on the same typed
    graph in both engines, seeded alike: every array of two batches
    equal, with and without features; Block has the reference's
    fields."""
    kw = {"feature_ids": ["feature"]} if features else {}
    pf = RelationDataFlow(_typed_graph(GraphBuilder), 3, 3, **kw)
    jf = JRelationDataFlow(_typed_graph(JGraphBuilder), 3, 3, **kw)
    roots = np.array([0, 5, 5, 11], np.uint64)
    p_seed(9)
    j_seed(9)
    for _ in range(2):
        got, want = pf(roots), jf(roots)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert got["nbr_ids"].shape == (3, 4, 3)
    fields = dict(n_id=np.arange(3, dtype=np.uint64),
                  res_n_id=np.arange(2, dtype=np.uint64),
                  edge_index=np.zeros((2, 1), np.int32), size=(3, 2))
    assert list(Block.__dataclass_fields__) == \
        list(JBlock.__dataclass_fields__)
    assert Block(**fields).size == JBlock(**fields).size


@pytest.mark.parametrize("shared", [False, True])
def test_group_gnn_matches_the_reference(shared):
    """GroupGNNNet (gnn_0, gnn_1) and its shared form (one gnn) over two
    edge groups of an 11-node graph, GCN layers of width 4, combined by
    AttLayer: the root rows and every gradient."""
    rng = np.random.default_rng(4)
    x, ei, _ = _graph(rng)
    batch = {"x": x, "root_index": np.array([1, 2, 9], np.int32),
             "group_edge_index": [ei[:, :20], ei[:, 20:]]}
    cot = rng.normal(size=(3, 4)).astype(np.float32)
    jb = {"x": jnp.asarray(x), "root_index": jnp.asarray(batch["root_index"]),
          "group_edge_index": [jnp.asarray(g) for g in
                               batch["group_edge_index"]]}
    params, _, want, want_g = _ref(
        JGroupGNNNet("gcn", 4, 2, 2, shared=shared), (jb,),
        lambda o: (o * cot).sum())
    cls = SharedGroupGNNNet if shared else GroupGNNNet
    net = cls(5, "gcn", 4, 2, 2)
    _load(net, params)
    got = net({"x": torch.from_numpy(x),
               "root_index": torch.from_numpy(batch["root_index"]),
               "group_edge_index": [torch.from_numpy(g) for g in
                                    batch["group_edge_index"]]})
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want)
    _close_grads(_port_grads(net), want_g)


# -- the runners' batches ------------------------------------------------------

def _reference_batches(script, argv, count, monkeypatch):
    """The first `count` batches the reference runner's input_fn yields
    (its train and evaluate are replaced by a reader of the stream)."""
    spec = importlib.util.spec_from_file_location(
        "ref_kg_runner", ROOT / "examples" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []

    def take(self, input_fn, steps):
        it = input_fn()
        seen.extend(next(it) for _ in range(count))
        return {"loss": 0.0}

    monkeypatch.setattr(JBase, "train", take)
    monkeypatch.setattr(JBase, "evaluate", lambda self, fn, steps: {})
    j_seed(5)
    mod.main([*argv, "--platform", "cpu"])
    return seen


@pytest.fixture(scope="module")
def fb15k237():
    """The port's fb15k237 stand-in, built once for both runners below
    (each seeds the engine before drawing)."""
    return PK.load_kg("fb15k237")


@pytest.mark.parametrize("runner", ["transx", "rgcn"])
def test_kg_runner_batches_match_the_reference(runner, monkeypatch,
                                                fb15k237):
    """Two batches of the TransX and R-GCN runners (their defaults on
    the fb15k237 stand-in) from both packages, engines seeded alike and
    numpy's default_rng(0): every array equal."""
    kg = fb15k237
    p_seed(5)
    rng = np.random.default_rng(0)
    if runner == "transx":
        want = _reference_batches("TransX/run_transx.py", [], 2,
                                  monkeypatch)
        it = triple_input_fn(kg.engine, kg.num_entities, 256, 16, rng)()
    else:
        want = _reference_batches("rgcn/run_rgcn.py", [], 2, monkeypatch)
        it = rgcn_input_fn(kg.engine, kg.num_entities, kg.num_relations,
                           128, 8, 8, 16, rng)()
    for w in want:
        got = next(it)
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
