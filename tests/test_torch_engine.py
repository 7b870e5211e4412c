"""The port's graph-engine binding against the JAX package's, on the CPU:
the two libraries are distinct builds of the same C++ with their own
RNGs, the ctypes signatures agree, the same arrays through both
GraphBuilders read back alike, seeded draws (sample_node,
sample_neighbor, sample_fanout, random_walk, gen_pair, a FanoutDataFlow
batch) are byte-identical, get_dataset's engines match, and the
neighbor and feature tables built from an engine graph are
byte-identical to the reference's and to the port's from_arrays twins.

Every comparison here is exact (byte for byte). The port's library is
built once per checkout (about 20 s on 8 cores) and shared by every
test that loads it."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import ctypes
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from euler_tpu.core import lib as J_lib
from euler_tpu.dataflow import FanoutDataFlow as JFanoutDataFlow
from euler_tpu.graph import GraphBuilder as JGraphBuilder
from euler_tpu.graph import seed as j_seed
from euler_tpu.ops.walk_ops import gen_pair as j_gen_pair
from euler_tpu.parallel import DeviceFeatureStore as JDeviceFeatureStore
from euler_tpu.parallel import DeviceNeighborTable as JDeviceNeighborTable
from euler_tpu.parallel import DeviceNodeSampler as JDeviceNodeSampler
from euler_tpu_torch.core import lib as P_lib
from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.dataset import engine_from_arrays
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.retry import EngineError
from euler_tpu_torch.graph import GraphBuilder, GraphEngine
from euler_tpu_torch.graph import seed as p_seed
from euler_tpu_torch.ops.walk_ops import gen_pair, random_walk
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

ROOT = Path(__file__).resolve().parents[1]
N, E, D, C = 200, 1500, 8, 4


def _arrays():
    """A weighted, typed graph with sparse u64 ids (one id past 2^40),
    dense features and labels, from a numpy seed."""
    rng = np.random.default_rng(11)
    ids = (np.arange(1, N + 1, dtype=np.uint64) * 3)
    ids[-1] = np.uint64(1 << 40)
    types = rng.integers(0, 3, N).astype(np.int32)
    nw = rng.uniform(0.5, 2.0, N).astype(np.float32)
    src = ids[rng.integers(0, N, E)]
    dst = ids[rng.integers(0, N, E)]
    et = rng.integers(0, 2, E).astype(np.int32)
    ew = rng.uniform(0.1, 3.0, E).astype(np.float32)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, N)]
    return ids, types, nw, src, dst, et, ew, feats, labels


def _build(builder_cls):
    ids, types, nw, src, dst, et, ew, feats, labels = _arrays()
    b = builder_cls()
    b.set_num_types(3, 2)
    b.set_feature(0, 0, D, "feature")
    b.set_feature(1, 0, C, "label")
    b.add_nodes(ids, types=types, weights=nw)
    b.add_edges(src, dst, types=et, weights=ew)
    b.set_node_dense(ids, 0, feats)
    b.set_node_dense(ids, 1, labels)
    return b.finalize()


@pytest.fixture(scope="module")
def graphs():
    return _build(GraphBuilder), _build(JGraphBuilder)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- the binding -------------------------------------------------------------

def test_the_port_loads_its_own_build_of_the_engine():
    """The port's library lies under build/euler_tpu_torch/engine, keyed
    on its sources' hash, and is another file than the JAX package's;
    an engine failure raises the port's EngineError."""
    p, j = P_lib.load(), J_lib.load()
    path = Path(p._name).resolve()
    assert path == P_lib.library_path().resolve()
    assert path.is_relative_to(ROOT / "build" / "euler_tpu_torch" / "engine")
    assert path.name == "libeuler_core.so"
    assert not os.path.samefile(path, j._name)
    assert p._handle != j._handle
    assert len(P_lib.sources()) == 19
    assert "engine_test.cc" not in {s.name for s in P_lib.sources()}
    with pytest.raises(EngineError):
        GraphEngine.load(str(ROOT / "build" / "no_such_graph"))


def test_seeding_one_library_leaves_the_others_stream(graphs):
    """Each library keeps its own RNG: seeding the port's between two
    equal seedings of the reference's does not move the reference's
    draws, and the other way round; under one seed both draw alike."""
    pg, jg = graphs
    for seed_a, draw_a, seed_b in ((j_seed, jg.sample_node, p_seed),
                                   (p_seed, pg.sample_node, j_seed)):
        seed_a(5)
        first = draw_a(64)
        seed_a(5)
        seed_b(12345)
        _same(draw_a(64), first)
    p_seed(7)
    j_seed(7)
    _same(pg.sample_node(64), jg.sample_node(64))


def test_ctypes_signatures_match_the_reference():
    """Every symbol the port declares has the restype and argtypes the
    reference's _declare gives it (recorded on a stub library)."""

    class _Fn:
        pass

    class _Stub:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, _Fn())

    stub = _Stub()
    J_lib._declare(stub)
    assert set(P_lib.SIGNATURES) <= set(stub.fns)
    for name, (restype, argtypes) in P_lib.SIGNATURES.items():
        ref = stub.fns[name]
        assert restype == ref.restype, name
        assert list(argtypes) == list(ref.argtypes), name
    assert P_lib.c_u64p is ctypes.POINTER(ctypes.c_uint64)


# -- reads and seeded draws ----------------------------------------------------

def test_reads_match_the_reference(graphs):
    pg, jg = graphs
    assert (pg.node_count, pg.edge_count, pg.num_node_types,
            pg.num_edge_types) == (jg.node_count, jg.edge_count,
                                   jg.num_node_types, jg.num_edge_types)
    ids = pg.all_node_ids()
    _same(ids, jg.all_node_ids())
    probe = np.concatenate([ids[::7], np.array([5, 1 << 41], np.uint64)])
    _same(pg.node_rows(probe, missing=N), jg.node_rows(probe, missing=N))
    for kw in ({}, {"edge_types": [1]}, {"sorted_by_id": True},
               {"in_edges": True}):
        for a, b in zip(pg.get_full_neighbor(ids, **kw),
                        jg.get_full_neighbor(ids, **kw)):
            _same(a, b)
    for fid in (["feature"], "label", ["feature", "label"]):
        got, want = pg.get_dense_feature(probe, fid), \
            jg.get_dense_feature(probe, fid)
        for a, b in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            _same(a, b)
    _same(pg.get_node_type(probe), jg.get_node_type(probe))
    _same(pg.all_node_weights(), jg.all_node_weights())


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_draws_are_byte_identical(graphs, seed):
    """sample_node (all nodes, one type), sample_neighbor (out, in, a
    type filter), sample_edge, sample_fanout, random_walk (uniform and
    node2vec's p, q) and gen_pair under the same seed, on this thread."""
    pg, jg = graphs
    draws = []
    for g, s in ((pg, p_seed), (jg, j_seed)):
        s(seed)
        roots = g.sample_node(32)
        out = [roots, g.sample_node(16, 1), *g.sample_edge(16)]
        out += g.sample_neighbor(roots, 5)
        out += g.sample_neighbor(roots, 3, edge_types=[0], in_edges=True)
        for hop in g.sample_fanout(roots, [4, 3]):
            out += hop
        out += g.sample_fanout(roots, [2, 2], edge_types=[[0], [1]])[0]
        out.append(g.random_walk(roots, 4))
        out.append(g.random_walk(roots, 4, p=0.5, q=2.0))
        draws.append(out)
    for a, b in zip(*draws):
        _same(a, b)
    p_seed(seed)
    walks = random_walk(pg, pg.sample_node(32), 4, p=0.5, q=2.0)
    j_seed(seed)
    _same(walks, jg.random_walk(jg.sample_node(32), 4, p=0.5, q=2.0))
    for win in ((1, 1), (2, 0), (0, 3)):
        _same(gen_pair(walks, *win), j_gen_pair(walks, *win))


def test_fanout_dataflow_batch_is_byte_identical(graphs):
    pg, jg = graphs
    batches = []
    for g, s, flow in ((pg, p_seed, FanoutDataFlow),
                       (jg, j_seed, JFanoutDataFlow)):
        s(4)
        f = flow(g, [5, 3], feature_ids=["feature"])
        batches.append(f(g.sample_node(24)))
    a, b = batches
    assert sorted(a) == sorted(b) == ["ids", "layers", "types", "weights"]
    for k in a:
        for x, y in zip(a[k], b[k]):
            _same(x, y)


@pytest.mark.parametrize("name", ["cora", "ppi"])
def test_get_dataset_engine_matches_the_reference(name):
    from euler_tpu.dataset import get_dataset as jax_get_dataset
    from euler_tpu_torch.dataset import get_dataset

    got, want = get_dataset(name), jax_get_dataset(name)
    assert (got.num_classes, got.feature_dim, got.max_id,
            got.multilabel) == (want.num_classes, want.feature_dim,
                                want.max_id, want.multilabel)
    pg, jg = got.engine, want.engine
    assert (pg.node_count, pg.edge_count) == (jg.node_count, jg.edge_count)
    ids = jg.all_node_ids()
    _same(pg.all_node_ids(), ids)
    for a, b in zip(pg.get_full_neighbor(ids), jg.get_full_neighbor(ids)):
        _same(a, b)
    for fid in ("feature", "label"):
        _same(pg.get_dense_feature(ids, fid), jg.get_dense_feature(ids, fid))
    _same(pg.get_node_type(ids), jg.get_node_type(ids))


# -- tables built from an engine graph ---------------------------------------

def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("layout", [{}, {"fused": True}, {"alias": True},
                                    {"edge_types": [1], "seed": 3}])
def test_neighbor_tables_from_an_engine_match_the_reference(graphs, layout):
    """DeviceNeighborTable(graph) over the weighted, typed graph: the
    split, fused and alias tables (and an edge-type filter with another
    draw seed) byte-identical to the reference's, with its stats."""
    pg, jg = graphs
    got = DeviceNeighborTable(pg, cap=8, device="cpu", **layout)
    want = JDeviceNeighborTable(jg, cap=8, **layout)
    assert got.tables.keys() == want.tables.keys()
    for k, t in got.tables.items():
        _same(t.numpy(), _np(want.tables[k]))
    assert (got.pad_row, got.cap, got.uniform_rows, got.hub_frac,
            got.edge_keep_frac, got.max_degree) == (
        want.pad_row, want.cap, want.uniform_rows, want.hub_frac,
        want.edge_keep_frac, want.max_degree)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        DeviceNeighborTable(pg, device="cpu", shard_rows=True)
    with pytest.raises(ValueError, match="split"):
        DeviceNeighborTable(pg, device="cpu", fused=True, alias=True)


def test_engine_tables_match_the_reference_and_from_arrays():
    """On the citation stand-in in the engine: DeviceNeighborTable(graph)
    equals the reference's over its own engine and the port's from_csr
    over the arrays (to_csr); DeviceFeatureStore(graph) in float32, int8
    and bfloat16 equals the reference's, and its int8 float32-scale
    tables the port's from_arrays; DeviceNodeSampler(graph) the
    reference's; lookup is the engine's row translation."""
    from euler_tpu.dataset.base_dataset import synthetic_citation as jsynth

    kw = dict(n=300, d=16, num_classes=4, seed=3)
    arrays = synthetic_citation(**kw)
    pg = engine_from_arrays(arrays).engine
    jg = jsynth("t", **kw).engine
    for layout in ({}, {"fused": True}, {"alias": True}):
        got = DeviceNeighborTable(pg, cap=8, device="cpu", **layout)
        want = JDeviceNeighborTable(jg, cap=8, **layout)
        twin = DeviceNeighborTable.from_csr(arrays.offsets, arrays.neighbors,
                                            cap=8, device="cpu", **layout)
        for k, t in got.tables.items():
            _same(t.numpy(), _np(want.tables[k]))
            _same(t.numpy(), twin.tables[k].numpy())
    import jax.numpy as jnp

    for quantize, dtype, jdtype in ((None, torch.float32, jnp.float32),
                                    ("int8", torch.float32, jnp.float32),
                                    ("int8", torch.bfloat16, jnp.bfloat16),
                                    (None, torch.bfloat16, jnp.bfloat16)):
        got = DeviceFeatureStore(pg, ["feature"], label_fid="label",
                                 label_dim=4, dtype=dtype,
                                 quantize=quantize, device="cpu",
                                 keep_host=True)
        want = JDeviceFeatureStore(jg, ["feature"], label_fid="label",
                                   label_dim=4, dtype=jdtype,
                                   quantize=quantize)
        for a, b in ((got.features, want.features),
                     (got.feature_scale, want.feature_scale),
                     (got.labels, want.labels)):
            if a is None:
                assert b is None
                continue
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), _np(b).view(np.int16)
            _same(a.numpy(), _np(b))
        assert got.host_arrays is not None and got.pad_row == want.pad_row
    twin = DeviceFeatureStore.from_arrays(
        np.concatenate([arrays.features, np.zeros((1, 16), np.float32)]),
        np.concatenate([arrays.onehot_labels(),
                        np.zeros((1, 4), np.float32)]),
        quantize="int8", device="cpu")
    got = DeviceFeatureStore(pg, ["feature"], label_fid="label",
                             label_dim=4, quantize="int8", device="cpu")
    for a, b in ((got.features, twin.features),
                 (got.feature_scale, twin.feature_scale),
                 (got.labels, twin.labels)):
        _same(a.numpy(), b.numpy())
    probe = np.array([0, 5, 299, 300, 1 << 40], np.uint64)
    _same(got.lookup(probe), np.asarray(
        JDeviceFeatureStore(jg, ["feature"]).lookup(probe)))
    for node_type in (-1, 1):
        got = DeviceNodeSampler(pg, node_type=node_type, device="cpu")
        want = JDeviceNodeSampler(jg, node_type=node_type)
        _same(got.rows.numpy(), _np(want.rows))
        _same(got.cum.numpy(), _np(want.cum))
