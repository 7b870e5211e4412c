"""The full-batch message-passing library of the port against the JAX
package, on the CPU: mp_ops, the eleven node-classification
convolutions (through BaseGNNNet, and DNAConv on a layer history),
JKGNNNet, the bipartite inputs, get_conv's errors, WholeDataFlow and
FullBatchDataFlow, and the citation runners.

Inputs are made with numpy from a seed; the reference's parameters are
carried into the port by euler_tpu_torch.convert. The graph has 12
nodes, repeated edges (so GAT's and AGNN's attention logits tie inside
a segment) and an isolated node (an empty segment). Tolerances (float32
throughout): forward outputs and gradients rtol 1e-5, atol 1e-6 (the
segment sums add in another order than XLA's); mp_ops' forward outputs
rtol 1e-6. The reference's programs are jitted at XLA's lowest backend
optimization level (the same HLO, compiled faster)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu import convolution as JC
from euler_tpu.dataflow import FullBatchDataFlow as JFullBatchDataFlow
from euler_tpu.dataflow import WholeDataFlow as JWholeDataFlow
from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth
from euler_tpu.graph import seed as j_seed
from euler_tpu.mp_utils import BaseGNNNet as JBaseGNNNet
from euler_tpu.mp_utils import JKGNNNet as JJKGNNNet
from euler_tpu.mp_utils.base_gnn import get_conv as jget_conv
from euler_tpu.ops import mp_ops as jmp
from euler_tpu_torch import convolution as C
from euler_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from euler_tpu_torch.dataflow import FullBatchDataFlow, WholeDataFlow
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet, JKGNNNet, get_conv
from euler_tpu_torch.ops import mp_ops as pmp

_O0 = {"xla_backend_optimization_level": 0}
N_NODES, IN_DIM, DIM = 12, 6, 5
RTOL, ATOL = 1e-5, 1e-6


def _graph(seed: int = 0):
    """(x [12, 6], edge_index [2, E] int32, root_index): random edges
    among nodes 0-10, three of them repeated, node 11 isolated."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_NODES - 1, 24)
    dst = rng.integers(0, N_NODES - 1, 24)
    src, dst = np.concatenate([src, src[:3]]), np.concatenate([dst, dst[:3]])
    x = rng.normal(size=(N_NODES, IN_DIM)).astype(np.float32)
    edge_index = np.stack([src, dst]).astype(np.int32)
    roots = np.array([3, 0, 11, 7, 3], np.int32)
    return x, edge_index, roots


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_trees(got, want, rtol=RTOL, atol=ATOL):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g_, w in zip(gl, wl):
        _close(g_, w, rtol, atol)


def _ref_value_and_grads(jm, batch, cot):
    """The reference module's output and its parameters' gradients of
    sum(output * cot), jitted."""
    params = jax.jit(jm.init, compiler_options=_O0)(jax.random.key(0),
                                                    batch)

    def loss(p):
        out = jm.apply(p, batch)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True),
                              compiler_options=_O0)(params)
    return params, out, grads


def _port_value_and_grads(model, params, batch, cot):
    model.load_state_dict(flax_to_state_dict(params))
    out = model(batch)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = state_dict_to_flax({k: p.grad for k, p in
                                model.named_parameters()})
    return out.detach(), {"params": grads}


def _torch_batch(x, edge_index, roots):
    return {"x": torch.from_numpy(x), "edge_index": torch.from_numpy(
        edge_index), "root_index": torch.from_numpy(roots)}


# -- mp_ops -------------------------------------------------------------------

def _segments():
    """src [10, 3] with ties inside segments, an out-of-order index over
    7 segments of which 1, 4 and 6 are empty."""
    rng = np.random.default_rng(1)
    src = rng.normal(size=(10, 3)).astype(np.float32)
    src[4] = src[1]           # a tie in segment 3
    src[7, 0] = src[2, 0]     # a tie in segment 5, first column only
    index = np.array([3, 3, 5, 0, 3, 2, 0, 5, 2, 5], np.int32)
    return src, index, 7


@pytest.mark.parametrize("fn", ["gather", "scatter_add", "scatter_mean",
                                "scatter_max", "segment_count",
                                "scatter_softmax", "degree_norm"])
def test_mp_op_matches_the_reference(fn):
    """Each primitive against JAX's on the same arrays: the output
    (rtol 1e-6), and where it is differentiable the gradient of
    sum(output * cotangent) (rtol 1e-5). scatter_max's empty segments
    are 0 in both; its ties split their gradient as JAX's do; the
    softmax's gradient does not see how its stabilizer's ties split."""
    src, index, n = _segments()
    rng = np.random.default_rng(2)
    if fn == "gather":
        args = (src, np.array([9, 0, 4, 4, 2], np.int32))
    elif fn == "segment_count":
        args = (index, n)
    elif fn == "degree_norm":
        args = (np.stack([index, index[::-1]]), n)
    elif fn == "scatter_softmax":
        args = (src[:, :2], index, n)
    else:
        args = (src, index, n)
    want = getattr(jmp, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args])
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
    got = getattr(pmp, fn)(*t_args)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, rtol=1e-6)
    if fn in ("segment_count", "degree_norm"):
        return
    cot = rng.normal(size=want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda s: getattr(jmp, fn)(s, *[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a
        for a in args[1:]]), jnp.asarray(args[0]))
    (want_g,) = vjp(jnp.asarray(cot))
    s = t_args[0].clone().requires_grad_(True)
    (getattr(pmp, fn)(s, *t_args[1:]) * torch.from_numpy(cot)).sum(
    ).backward()
    _close(s.grad, want_g)


@pytest.mark.parametrize("fn", ["gather", "scatter_add", "scatter_mean",
                                "scatter_max", "segment_count",
                                "scatter_softmax"])
def test_mp_op_out_of_range_indices_match_the_reference(fn):
    """src = arange(12).reshape(4, 3), segment ids [0, 1, -1, 3] over 3
    segments, gather rows [-1, 5]: gather wraps -1 and fills 5 with NaN
    (jnp.take's fill mode), the segment ops drop -1 and 3
    (jax.ops.segment_sum / segment_max), exact; scatter_softmax does not
    raise and its in-range entries (0 and 1) equal the reference's
    (rtol 1e-6; the dropped entries mean nothing in either). The
    gradients of gather and scatter_add too: 0 for a filled or dropped
    row."""
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    index = np.array([0, 1, -1, 3], np.int32)
    if fn == "gather":
        args = (src, np.array([-1, 5], np.int32))
    elif fn == "segment_count":
        args = (index, 3)
    elif fn == "scatter_softmax":
        args = (src[:, 0], index, 3)
    else:
        args = (src, index, 3)
    want = np.asarray(getattr(jmp, fn)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    t_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
    got = getattr(pmp, fn)(*t_args).numpy()
    if fn == "scatter_softmax":
        _close(got[:2], want[:2], rtol=1e-6, atol=0)
        assert np.isfinite(got).all()
        return
    np.testing.assert_array_equal(got, want)
    if fn not in ("gather", "scatter_add"):
        return
    cot = np.arange(want.size, dtype=np.float32).reshape(want.shape) + 1
    _, vjp = jax.vjp(lambda s: getattr(jmp, fn)(s, jnp.asarray(args[1]),
                                               *args[2:]), jnp.asarray(src))
    (want_g,) = vjp(jnp.asarray(cot))
    s = t_args[0].clone().requires_grad_(True)
    (torch.nan_to_num(getattr(pmp, fn)(s, *t_args[1:]))
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(s.grad.numpy(), np.asarray(want_g))


# -- the convolutions ---------------------------------------------------------

CONVS = ["gcn", "sage", "gat", "agnn", "gin", "graph", "sgcn", "tag",
         "arma", "appnp", "dna"]
# conv_kwargs of the stacks: GAT with two heads, ARMA two stacks of depth
# two, TAG three powers
KWARGS = {"gat": {"heads": 2}, "arma": {"num_stacks": 2, "arma_layers": 2},
          "tag": {"k_hop": 3}, "appnp": {"k_hop": 4, "alpha": 0.2}}


@pytest.mark.parametrize("name", CONVS)
def test_conv_matches_the_reference(name):
    """BaseGNNNet(name) of two layers (appnp: the MLP then the
    propagation; sgcn: one SGCNConv of two steps) on the 12-node graph,
    the reference's parameters carried across: the root rows'
    embeddings and every parameter's gradient within rtol 1e-5.
    'dna': DNAConv (2 heads) on a [N, 3, 4] history."""
    x, edge_index, roots = _graph()
    rng = np.random.default_rng(3)
    if name == "dna":
        hist = rng.normal(size=(N_NODES, 3, 4)).astype(np.float32)
        jm = JC.DNAConv(out_dim=4, heads=2)
        params = jax.jit(jm.init, compiler_options=_O0)(
            jax.random.key(0), jnp.asarray(hist), jnp.asarray(edge_index))
        cot = rng.normal(size=(N_NODES, 4)).astype(np.float32)

        def loss(p):
            out = jm.apply(p, jnp.asarray(hist), jnp.asarray(edge_index))
            return (out * cot).sum(), out

        (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                    compiler_options=_O0)(params)
        model = C.DNAConv(4, 4, heads=2)
        model.load_state_dict(flax_to_state_dict(params))
        got = model(torch.from_numpy(hist), torch.from_numpy(edge_index))
        (got * torch.from_numpy(cot)).sum().backward()
        got_g = {"params": state_dict_to_flax(
            {k: p.grad for k, p in model.named_parameters()})}
    else:
        kw = KWARGS.get(name, {})
        jm = JBaseGNNNet(name, DIM, 2, conv_kwargs=kw)
        batch = {"x": jnp.asarray(x), "edge_index": jnp.asarray(edge_index),
                 "root_index": jnp.asarray(roots)}
        model = BaseGNNNet(name, IN_DIM, DIM, 2, conv_kwargs=kw)
        cot = rng.normal(size=(len(roots), model.out_dim)).astype(np.float32)
        params, want, want_g = _ref_value_and_grads(jm, batch, cot)
        got, got_g = _port_value_and_grads(
            model, params, _torch_batch(x, edge_index, roots), cot)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.detach(), want)
    _close_trees(got_g, want_g)


def test_jk_gnn_net_matches_the_reference():
    """JKGNNNet (three GCN layers, their outputs concatenated): the root
    rows and the gradients within rtol 1e-5."""
    x, edge_index, roots = _graph(1)
    jm = JJKGNNNet("gcn", DIM, 3)
    batch = {"x": jnp.asarray(x), "edge_index": jnp.asarray(edge_index),
             "root_index": jnp.asarray(roots)}
    model = JKGNNNet("gcn", IN_DIM, DIM, 3)
    assert model.out_dim == 3 * DIM
    cot = np.random.default_rng(4).normal(
        size=(len(roots), model.out_dim)).astype(np.float32)
    params, want, want_g = _ref_value_and_grads(jm, batch, cot)
    got, got_g = _port_value_and_grads(
        model, params, _torch_batch(x, edge_index, roots), cot)
    _close(got, want)
    _close_trees(got_g, want_g)


@pytest.mark.parametrize("cls", ["GCNConv", "SAGEConv", "GATConv"])
def test_bipartite_input_matches_the_reference(cls):
    """A bipartite block (x_src [12, 6], x_tgt [5, 6] as a tuple; edges
    from all 12 sources into 5 targets): GCN's row normalization, SAGE's
    target-and-mean concat, GAT's self logits 2·alpha_dst; outputs and
    gradients within rtol 1e-5."""
    x, edge_index, _ = _graph(2)
    rng = np.random.default_rng(5)
    x_tgt = rng.normal(size=(5, IN_DIM)).astype(np.float32)
    ei = np.stack([edge_index[0], edge_index[1] % 5]).astype(np.int32)
    kw = {"heads": 2} if cls == "GATConv" else {}
    jm = getattr(JC, cls)(out_dim=DIM, **kw)
    jx = (jnp.asarray(x), jnp.asarray(x_tgt))
    params = jax.jit(jm.init, compiler_options=_O0)(
        jax.random.key(0), jx, jnp.asarray(ei))
    model = getattr(C, cls)(IN_DIM, DIM, **kw)
    cot = rng.normal(size=(5, model.out_dim)).astype(np.float32)

    def loss(p):
        out = jm.apply(p, jx, jnp.asarray(ei))
        return (out * cot).sum(), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True),
                                compiler_options=_O0)(params)
    model.load_state_dict(flax_to_state_dict(params))
    got = model((torch.from_numpy(x), torch.from_numpy(x_tgt)),
                torch.from_numpy(ei))
    (got * torch.from_numpy(cot)).sum().backward()
    got_g = {"params": state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()})}
    _close(got.detach(), want)
    _close_trees(got_g, want_g)
    if cls != "SAGEConv":
        with pytest.raises(ValueError, match="shared node set"):
            C.SGCNConv(IN_DIM, DIM)((torch.from_numpy(x),
                                     torch.from_numpy(x_tgt)),
                                    torch.from_numpy(ei))


def test_get_conv_errors_and_fresh_init():
    """get_conv: an unknown name raises the reference's ValueError (the
    same list of options), relation builds a RelationConv with the
    num_relations it is given, gated builds a GatedGraphConv. A fresh GAT has
    flax's glorot-uniform attention bounds and AGNN's beta starts at
    1."""
    with pytest.raises(ValueError) as err:
        get_conv("nope", 4, 4, 0, 2, {})
    with pytest.raises(ValueError) as jerr:
        jget_conv("nope", 4, 0, 2, {})
    assert str(err.value) == str(jerr.value)
    rel = get_conv("relation", 4, 4, 0, 2, {"num_relations": 3})
    assert isinstance(rel, C.RelationConv)
    assert tuple(rel.w_rel.shape) == (3, 4, 4)
    assert isinstance(get_conv("gated", 4, 4, 0, 2, {}), C.GatedGraphConv)
    gat = C.GATConv(IN_DIM, 16, heads=8,
                    generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (8 + 16))
    top = float(gat.att_src.detach().abs().max())
    assert 0.9 * limit < top <= limit
    assert tuple(gat.att_dst.shape) == (1, 8, 16)
    assert float(C.AGNNConv(IN_DIM).beta.detach()) == 1.0


# -- the edge_index flows -----------------------------------------------------

KW = dict(n=200, d=8, num_classes=3, seed=4)


@pytest.fixture(scope="module")
def engines():
    """A citation stand-in in both engines (byte-identical graphs)."""
    return engine_from_arrays(synthetic_citation(**KW)).engine, \
        jsynth("t", **KW).engine


@pytest.mark.parametrize("flow", ["whole", "full"])
def test_edge_index_flows_match_the_reference(engines, flow):
    """WholeDataFlow (2 hops, padded to 16) and FullBatchDataFlow over
    the same engine graph, from the same engine-drawn roots: every
    array of the batch equal (exact)."""
    pg, jg = engines
    batches = []
    for g, seed_fn, cls in ((pg, p_seed, (WholeDataFlow, FullBatchDataFlow)),
                            (jg, j_seed, (JWholeDataFlow,
                                          JFullBatchDataFlow))):
        seed_fn(7)
        roots = g.sample_node(16, 0)
        f = (cls[0](g, hops=2, pad_to_multiple=16, feature_ids=["feature"])
             if flow == "whole" else cls[1](g, feature_ids=["feature"]))
        batches.append(f(roots))
    got, want = batches
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


# -- the runners --------------------------------------------------------------

@pytest.mark.parametrize("runner", ["run_gcn", "run_gat", "run_appnp",
                                    "run_agnn", "run_arma", "run_sgcn",
                                    "run_tagcn", "run_adaptivegcn",
                                    "run_dna"])
def test_citation_runner_runs_a_few_steps(runner, monkeypatch):
    """Each citation runner for 6 steps on a small stand-in (300 nodes,
    16 features) with its defaults otherwise: finite, nothing skipped, a
    test micro-F1; without --device it needs the card."""
    import importlib

    from euler_tpu_torch.examples import common

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    monkeypatch.setattr(common, "get_dataset", lambda name: engine_from_arrays(
        synthetic_citation(n=300, d=16, num_classes=3, seed=1, val=60,
                           test=100)))
    argv = ["--max_steps", "6", "--batch_size", "64"]
    res = mod.main([*argv, "--device", "cpu"])
    assert res["train_global_step"] == 6
    assert res["train_skipped_steps"] == 0
    assert np.isfinite(res["train_loss"])
    assert 0.0 <= res["test_metric"] <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
