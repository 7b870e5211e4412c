"""The port's GQL layer (euler_tpu_torch/gql.py) and op layer
(euler_tpu_torch/ops/{base,sample_ops,neighbor_ops,feature_ops,type_ops,
walk_ops}.py) against the JAX package's, on the CPU.

Each package compiles and runs the gremlin chains of tests/test_gql.py
in its own build of the engine, over the same graph built from the same
arrays: every `Query.local` result (seeded draws included) and every
`compile_debug` plan is held to the reference's exactly, and a chain
the reference refuses is refused with the same message. The op layer's
functions run over each package's process-global graph
(`initialize_graph`) under the same engine seed and must agree byte for
byte; conditioned draws (a Query with seed 0 draws fresh entropy in
both) are held by membership. One ring, one priced, one hub and one
byte-string graph per package serve every case (module fixtures)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)

import numpy as np
import pytest

from euler_tpu import gql as J_gql
from euler_tpu import ops as J_ops
from euler_tpu.core.lib import EngineError as JEngineError
from euler_tpu.graph import GraphBuilder as JGraphBuilder
from euler_tpu.graph import seed as j_seed
from euler_tpu_torch import gql as P_gql
from euler_tpu_torch import ops as P_ops
from euler_tpu_torch.estimator.retry import EngineError
from euler_tpu_torch.graph import GraphBuilder
from euler_tpu_torch.graph import seed as p_seed


def _ring(builder_cls, seed_fn):
    """tests/conftest.py:ring_graph, in either package."""
    seed_fn(1234)
    b = builder_cls()
    b.set_num_types(2, 2)
    b.set_feature(0, 0, 4, "f_dense")
    b.set_feature(1, 1, 0, "f_sparse")
    b.set_feature(0, 0, 2, "e_dense", edge=True)
    ids = np.arange(1, 11, dtype=np.uint64)
    b.add_nodes(ids, types=np.array([0, 1] * 5),
                weights=np.arange(1, 11, dtype=np.float32))
    src = np.concatenate([ids, ids])
    dst = np.concatenate([np.roll(ids, -1), np.roll(ids, -2)])
    et = np.array([0] * 10 + [1] * 10)
    w = np.arange(1, 21, dtype=np.float32)
    b.add_edges(src, dst, types=et, weights=w)
    b.set_node_dense(ids, 0, np.arange(40, dtype=np.float32).reshape(10, 4))
    b.set_node_sparse(ids, 1, np.arange(11, dtype=np.uint64) * 2,
                      np.arange(20, dtype=np.uint64))
    b.set_edge_dense(src, dst, et, 0,
                     np.stack([w, -w], axis=1).astype(np.float32))
    return b.finalize()


def _priced(builder_cls, seed_fn):
    """tests/test_gql.py:priced_graph, in either package."""
    seed_fn(99)
    b = builder_cls()
    b.set_num_types(2, 2)
    b.set_feature(0, 0, 1, "price")
    b.set_feature(1, 1, 0, "f_sparse")
    ids = np.arange(1, 11, dtype=np.uint64)
    b.add_nodes(ids, types=np.array([0, 1] * 5),
                weights=np.ones(10, dtype=np.float32))
    b.add_edges(ids, np.roll(ids, -1), types=np.zeros(10, dtype=np.int32),
                weights=np.ones(10, dtype=np.float32))
    b.set_node_dense(ids, 0, np.arange(10, dtype=np.float32).reshape(10, 1))
    b.set_node_sparse(ids, 1, np.arange(11, dtype=np.uint64),
                      (np.arange(10, dtype=np.uint64) % 3))
    return b.finalize()


def _hub(builder_cls, seed_fn):
    """tests/test_gql.py:test_layerwise_weight_func_sqrt's hub graph."""
    seed_fn(3)
    b = builder_cls()
    b.add_nodes(np.array([1, 2, 3], dtype=np.uint64))
    b.add_edges(np.array([1, 1], dtype=np.uint64),
                np.array([2, 3], dtype=np.uint64),
                weights=np.array([100.0, 1.0], np.float32))
    return b.finalize()


def _binary(builder_cls, seed_fn):
    """Node and edge byte strings and an edge sparse feature (the ring
    has none; a binary read of a non-binary feature is not a case)."""
    seed_fn(5)
    b = builder_cls()
    b.set_feature(0, 2, 0, "blob")
    b.set_feature(0, 2, 0, "e_blob", edge=True)
    b.set_feature(1, 1, 0, "e_sparse", edge=True)
    b.add_nodes(np.array([1, 2, 3], dtype=np.uint64))
    b.add_edges(np.array([1, 2], dtype=np.uint64),
                np.array([2, 3], dtype=np.uint64))
    for i, data in ((1, b"one"), (3, b"three!")):
        b.set_node_binary(i, 0, data)
    b.set_edge_binary(1, 2, 0, 0, b"edge-12")
    b.set_edge_sparse(2, 3, 0, 1, [7, 9, 11])
    return b.finalize()


_MAKERS = {"ring": _ring, "priced": _priced, "hub": _hub,
           "binary": _binary}


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(GraphBuilder, p_seed), make(JGraphBuilder, j_seed))
            for name, make in _MAKERS.items()}


def _u64(*v):
    return np.array(v, dtype=np.uint64)


def _same_outputs(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


_BATCH = {"batch:0": _u64(1), "batch:1": _u64(2),
          "batch:2": np.array([0], dtype=np.int32)}

# (graph, index_spec, Query seed, [(gremlin, inputs), ...] run in order
# on one Query): the chains of tests/test_gql.py:47-280 and :606-780
CHAINS = {
    "fused_fanout": ("ring", "", 42, [
        ("v(roots).sampleNB(0, 4, 0).as(h0).sampleNB(0, 3, 0).as(h1)",
         {"roots": _u64(1, 3, 5)})]),
    "sample_n": ("ring", "f_sparse:hash_index", 7, [
        ("sampleN(0, 32).as(n)", None)]),
    "v_values": ("ring", "", 0, [
        ("v(roots).values(f_dense).as(feat)", {"roots": _u64(1, 2)})]),
    "sample_nb_chain": ("ring", "", 3, [
        ("v(roots).sampleNB(0:1, 4, 0).as(nb_0).sampleNB(0:1, 3, 0)"
         ".as(nb_1)", {"roots": _u64(1, 2, 3)})]),
    "get_nb_label": ("ring", "", 0, [
        ("v(roots).getNB(0).as(nb).label().as(t)", {"roots": _u64(4)})]),
    "conditioned": ("priced", "price:range_index", 11, [
        ("sampleN(-1, 64).has(price gt 6).as(n)", None),
        ("sampleN(-1, 64).has(price le 1).as(m)", None)]),
    "conditioned_or": ("priced", "price:range_index", 1, [
        ("sampleN(-1, 64).has(price lt 1 or price gt 8).as(n)", None)]),
    "hash_index": ("priced", "f_sparse:hash_index", 5, [
        ("sampleN(-1, 48).has(f_sparse eq 2).as(n)", None)]),
    "v_has": ("priced", "price:range_index", 0, [
        ("v(roots).has(price ge 5).as(kept)", {"roots": _u64(2, 6, 7, 100)})]),
    "order_by_limit": ("ring", "", 0, [
        ("v(roots).getNB(*).orderBy(weight, desc).limit(1).as(top)",
         {"roots": _u64(1)})]),
    "udf_mean": ("ring", "", 0, [
        ("v(roots).udf(mean, f_dense).as(m)", {"roots": _u64(1)})]),
    "layerwise": ("ring", "", 2, [
        ("v(roots).sampleLNB(*, 4:6, 0).as(l)", {"roots": _u64(1, 2)})]),
    "layerwise_sqrt": ("hub", "", 5, [
        ("v(r).sampleLNB(*, 400, 0, sqrt).as(l)", {"r": _u64(1)}),
        ("v(r).sampleLNB(*, 400, 0).as(l)", {"r": _u64(1)}),
        ("v(r).sampleLNB(*, 8, 0, cube).as(l)", {"r": _u64(1)})]),
    "sample_edge": ("ring", "", 13, [("sampleE(0, 16).as(e)", None)]),
    "edge_values": ("ring", "", 0, [
        ("e(batch).values(e_dense).as(p)", _BATCH)]),
    "out_e": ("ring", "", 0, [
        ("v(roots).outE(*).as(e)", {"roots": _u64(1, 4)})]),
    "out_e_typed": ("ring", "", 0, [
        ("v(roots).outE(1).as(e)", {"roots": _u64(2)}),
        ("v(roots).outE(*).has(weight gt 10).as(e)", {"roots": _u64(1, 2)}),
        ("v(roots).outE(*).orderBy(weight, desc).limit(1).as(e)",
         {"roots": _u64(3, 8)})]),
    "out_e_values": ("ring", "", 0, [
        ("v(roots).outE(*).values(e_dense).as(f)", {"roots": _u64(5)})]),
    "out_e_out_v": ("ring", "", 0, [
        ("v(roots).outE(0).outV(0).values(f_dense).as(f)",
         {"roots": _u64(1)})]),
    "out_e_id_ne": ("ring", "", 0, [
        ("v(roots).outE(*).has(id ne 2).as(e)", {"roots": _u64(1)})]),
    "out_e_top": ("ring", "", 0, [
        ("v(roots).outE(*).orderBy(weight, desc).limit(1).as(top)",
         {"roots": _u64(3)})]),
    "out_e_bad_weight_op": ("ring", "", 0, [
        ("v(r).outE(*).has(weight in 1:5).as(e)", {"r": _u64(1)})]),
    "udf_builtins": ("ring", "", 0, [
        ("v(roots).udf(scale:2, f_dense).as(s)", {"roots": _u64(1)}),
        ("v(roots).udf(clip:1:2, f_dense).as(c)", {"roots": _u64(1)})]),
    "udf_unknown": ("ring", "", 0, [
        ("v(roots).udf(nosuch, f_dense).as(x)", {"roots": _u64(1)})]),
}


def _run_both(pq, jq, gremlin, inputs):
    try:
        want = jq.run(gremlin, inputs)
    except JEngineError as e:
        with pytest.raises(EngineError) as got:
            pq.run(gremlin, inputs)
        assert str(got.value) == str(e)
        return
    _same_outputs(pq.run(gremlin, inputs), want)


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_query_local_chain_matches_the_reference(graphs, case):
    """Query.local over the same graph, index spec and seed gives the
    reference's outputs exactly, run after run on one Query; the local
    plan (compile_debug) and explain() render the same text."""
    gname, spec, seed, runs = CHAINS[case]
    pg, jg = graphs[gname]
    pq = P_gql.Query.local(pg, index_spec=spec, seed=seed)
    jq = J_gql.Query.local(jg, index_spec=spec, seed=seed)
    try:
        for gremlin, inputs in runs:
            _run_both(pq, jq, gremlin, inputs)
            try:
                plan = J_gql.compile_debug(gremlin)
            except JEngineError:
                continue
            assert P_gql.compile_debug(gremlin) == plan
            assert pq.explain(gremlin) == jq.explain(gremlin)
    finally:
        pq.close()
        jq.close()


# (gremlin, shard_num, partition_num, mode) of tests/test_gql.py's
# compile cases; a chain the reference refuses must be refused alike
COMPILES = [
    ("v(roots).sampleNB(0, 5, 0).as(nb_0)", 1, 1, "local"),
    ("v(roots).bogusCall(1)", 1, 1, "local"),
    ("sampleN(0, 64).as(n)", 2, 2, "distribute"),
    ("v(roots).values(price).as(p)", 3, 3, "distribute"),
    ("v(roots).values(price).as(a).values(price).as(b)", 1, 1, "local"),
    ("v(roots).sampleNB(0, 5, 0).as(nb_0).sampleNB(0, 3, 0).as(nb_1)",
     1, 1, "local"),
    ("v(roots).sampleNB(0, 5, 0).as(nb)", 2, 2, "distribute"),
    ("v(roots).outE(*).as(e)", 1, 1, "local"),
    ("v(roots).outE(0).values(e_dense).as(f)", 1, 1, "local"),
    ("v(roots).outE(*).as(e)", 2, 2, "distribute"),
    ("v(r).outE(*).limit(1).has(weight gt 10)", 1, 1, "local"),
    ("v(r).outE(*).as(all).limit(1)", 1, 1, "local"),
    ("v(r).outE(*).as(all).orderBy(weight, desc)", 1, 1, "local"),
]


@pytest.mark.parametrize("gremlin,shards,parts,mode", COMPILES)
def test_compile_debug_matches_the_reference(gremlin, shards, parts, mode):
    try:
        want = J_gql.compile_debug(gremlin, shards, parts, mode)
    except JEngineError as e:
        with pytest.raises(EngineError) as got:
            P_gql.compile_debug(gremlin, shards, parts, mode)
        assert str(got.value) == str(e)
        return
    assert P_gql.compile_debug(gremlin, shards, parts, mode) == want


# -- the op layer ----------------------------------------------------------

def _flat(out):
    """Every array of an op's (nested) result, in order."""
    if isinstance(out, np.ndarray):
        return [out]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, (bytes, int, np.integer)):
        return [np.asarray(out if not isinstance(out, bytes)
                           else np.frombuffer(out, np.uint8))]
    raise TypeError(type(out))


_R = _u64(1, 2, 5, 9)
# exported function → (graph, args, kwargs); each runs in both packages
# under the same engine seed and must agree byte for byte
OPS = {
    "sample_node": ("ring", (8, -1), {}),
    "sample_edge": ("ring", (8, 1), {}),
    "sample_node_with_types": ("ring", (np.array([0, 1, 1], np.int32),), {}),
    "sample_node_with_src": ("ring", (_R, 3), {}),
    "sample_neighbor": ("ring", (_R, 4), {"edge_types": [0, 1]}),
    "sample_fanout": ("ring", (_R, [3, 2]), {}),
    "get_full_neighbor": ("ring", (_R,), {"edge_types": [1]}),
    "get_sorted_full_neighbor": ("ring", (_R,), {}),
    "get_neighbor_edges": ("ring", (_R,), {}),
    "get_top_k_neighbor": ("ring", (_R, 1), {}),
    "sample_neighbor_layerwise": ("ring", (_R, [4, 6]), {}),
    "get_multi_hop_neighbor": ("ring", (_R, [[0], None]), {}),
    "sample_fanout_layerwise_each_node": ("ring", (_R, [2, 5]), {}),
    "sample_fanout_layerwise": ("ring", (_R, [5, 5]),
                                {"weight_func": "sqrt"}),
    "sample_fanout_with_feature": ("ring", (_R, [2, 2]), {
        "dense_feature_names": ["f_dense"], "dense_dimensions": [4],
        "sparse_feature_names": ["f_sparse"]}),
    "sparse_get_adj": ("ring", (_R, _u64(2, 3, 6, 10, 11)), {}),
    "get_dense_feature": ("ring", (_R, ["f_dense"]), {}),
    "get_sparse_feature": ("ring", (_R, "f_sparse"), {}),
    "get_binary_feature": ("binary", (_u64(1, 2, 3), "blob"), {}),
    "get_edge_dense_feature": ("ring", (_u64(1, 4), _u64(2, 6),
                                        np.array([0, 1], np.int32),
                                        ["e_dense"]), {}),
    "get_edge_sparse_feature": ("binary", (_u64(1, 2), _u64(2, 3),
                                           np.array([0, 0], np.int32),
                                           "e_sparse"), {}),
    "get_edge_binary_feature": ("binary", (_u64(1, 2), _u64(2, 3),
                                           np.array([0, 0], np.int32),
                                           "e_blob"), {}),
    "get_node_type": ("ring", (_R,), {}),
    "get_node_type_id": ("ring", ([0, 1, "1"],), {}),
    "get_edge_type_id": ("ring", (1,), {}),
    "random_walk": ("ring", (_R, 4), {"p": 0.5, "q": 2.0}),
    "gen_pair": ("ring", (np.arange(12, dtype=np.uint64).reshape(3, 4),
                          1, 2), {}),
    # conditioned variants: a deterministic read through get_query()
    "get_full_neighbor[condition]": ("priced", (_R,),
                                     {"condition": "price ge 5"}),
    "get_sorted_full_neighbor[condition]": ("priced", (_R,),
                                            {"condition": "price lt 5"}),
    "get_top_k_neighbor[condition]": ("priced", (_R, 1),
                                      {"condition": "price ge 2"}),
}
_SPECS = {"priced": "price:range_index"}


def _call_op(pkg, graph, spec, name, args, kwargs, seed_fn):
    pkg.initialize_graph(graph)
    from importlib import import_module
    import_module(pkg.__name__ + ".base").set_index_spec(spec)
    seed_fn(77)
    fn = getattr(pkg, name.split("[")[0])
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # compared below: both must raise alike
        return e


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_layer_matches_the_reference(graphs, name):
    """Each function euler_tpu/ops exports, over each package's global
    graph (the port's random_walk reads it too, as the reference's
    does) and the same engine seed, gives the same bytes."""
    gname, args, kwargs = OPS[name]
    pg, jg = graphs[gname]
    spec = _SPECS.get(gname, "")
    got = _call_op(P_ops, pg, spec, name, args, kwargs, p_seed)
    want = _call_op(J_ops, jg, spec, name, args, kwargs, j_seed)
    if isinstance(want, Exception):
        assert isinstance(got, Exception) and str(got) == str(want)
        return
    assert not isinstance(got, Exception), got
    if name == "get_node_type_id" or name == "get_edge_type_id":
        np.testing.assert_array_equal(got, want)
        return
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape)
        assert x.tobytes() == y.tobytes()


def test_conditioned_draws_hold_their_condition(graphs):
    """sample_node / sample_neighbor with a condition draw through a
    Query of seed 0 (fresh entropy in both packages): held by
    membership, as tests/test_gql.py holds them."""
    pg, jg = graphs["priced"]
    for pkg, g in ((P_ops, pg), (J_ops, jg)):
        pkg.initialize_graph(g)
        pkg.base.set_index_spec("price:range_index")
        assert set(pkg.sample_node(64, -1, condition="price gt 6")) <= \
            {8, 9, 10}
        ids, _, _ = pkg.sample_neighbor(_R, 3, condition="price ge 5")
        # priced ring: i → i+1; price(i+1) = i, so only roots >= 5 keep
        # their one neighbor and the rest stay at default 0
        for root, row in zip(_R, ids):
            assert set(row) <= ({int(root) % 10 + 1, 0} if root >= 5
                                else {0})
