"""Graphs that change, in the port against the JAX package, on the CPU:
DeviceNeighborTable.patch_rows byte for byte against the reference's
(the hub-and-growth delta, an edge-only delta without growth, an empty
patch, the refused layouts), the tensors a patch binds (never the ones
an estimator merged before it), the alias rows counters, and
StreamingDriver: apply_delta's dict and counters against the
reference's, fine_tune's offset of max_steps, export without an
export_dir, a refused delta, and the reference's acceptance round
(delta → fine-tune → export → hot swap into an InferenceServer on
127.0.0.1, whose kNN then returns a node that did not exist at train
start).

The graphs are the reference's tests/test_streaming.py fixtures (a
40-node two-type graph with weighted, typed, partly duplicate edges and
its delta), built in each package's engine. Tables compare exactly
(bytes); no float tolerance is involved."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)

import numpy as np
import pytest
import torch

from euler_tpu import obs as j_obs
from euler_tpu.estimator import StreamingDriver as JDriver
from euler_tpu.graph import GraphBuilder as JBuilder
from euler_tpu.graph.api import delta_dirty_ids as j_dirty
from euler_tpu.parallel.device_sampler import DeviceNeighborTable as JTable
from euler_tpu_torch import obs
from euler_tpu_torch.estimator import StreamingDriver
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.graph import EngineError, GraphBuilder, delta_dirty_ids
from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable

CAP, SEED = 4, 7

# the reference's _DELTA (tests/test_streaming.py:60-68): two new nodes,
# an updated node, new and updated edges
DELTA = {
    "node_ids": np.array([101, 102, 7], np.uint64),
    "node_types": np.array([0, 1, 1], np.int32),
    "node_weights": np.array([1.5, 2.5, 9.0], np.float32),
    "edge_src": np.array([101, 102, 3, 3], np.uint64),
    "edge_dst": np.array([1, 101, 4, 102], np.uint64),
    "edge_types": np.array([0, 1, 0, 0], np.int32),
    "edge_weights": np.array([0.5, 0.6, 7.0, 0.8], np.float32),
}
EDGE_ONLY = {"edge_src": np.array([3], np.uint64),
             "edge_dst": np.array([5], np.uint64),
             "edge_weights": np.array([4.0], np.float32)}


def _builder(cls, n=40, final=False):
    """The reference's _base_builder (and, final=True, _scratch_final:
    the base graph with the delta built in from scratch)."""
    rng = np.random.default_rng(5)
    b = cls()
    b.set_num_types(2, 2)
    b.set_feature(0, 0, 3, "feat")
    b.set_feature(1, 1, 0, "tags")
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b.add_nodes(ids, types=(ids % 2).astype(np.int32),
                weights=np.linspace(1, 2, n).astype(np.float32))
    m = n * 4
    src = rng.integers(1, n + 1, m).astype(np.uint64)
    dst = rng.integers(1, n + 1, m).astype(np.uint64)
    et = rng.integers(0, 2, m).astype(np.int32)
    w = (rng.random(m) + 0.1).astype(np.float32)
    b.add_edges(src, dst, types=et, weights=w)
    b.set_node_dense(ids, 0, rng.random((n, 3), dtype=np.float32))
    b.set_node_sparse(ids, 1, np.arange(n + 1, dtype=np.uint64) * 2,
                      np.arange(2 * n, dtype=np.uint64))
    if final:
        b.add_nodes(DELTA["node_ids"], types=DELTA["node_types"],
                    weights=DELTA["node_weights"])
        b.add_edges(DELTA["edge_src"], DELTA["edge_dst"],
                    types=DELTA["edge_types"],
                    weights=DELTA["edge_weights"])
    return b


def _tables(t):
    """(nbr, cum, alias) of a table of either package, as numpy."""
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in (t.neighbors, t.cum_weights, t.alias_table)]


def _same_tables(p, j):
    for a, b in zip(_tables(p), _tables(j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for a, b in zip(p.host_tables, j.host_tables):
        assert a.tobytes() == b.tobytes()
    assert (p.pad_row, p.uniform_rows, p.max_degree) == \
        (j.pad_row, j.uniform_rows, j.max_degree)


def _counter(registry, name: str) -> float:
    return registry.default_registry().counter(name).value


class _Probe(torch.nn.Module):
    """A model whose only use here is an estimator's static_batch."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


def test_patch_rows_with_hubs_and_growth_matches_the_reference():
    """The reference's hub-and-growth case (cap 4 under the max degree,
    two new nodes, seed 7, alias): stats, nbr / cum / alias tables, the
    host copies, pad_row, uniform_rows and max_degree byte for byte, and
    equal to a build from scratch on the final edge set; the old
    tensors are left as they were, and an estimator that merged them
    before the patch still holds them."""
    pg, jg = _builder(GraphBuilder).finalize(), _builder(JBuilder).finalize()
    p = DeviceNeighborTable(pg, cap=CAP, seed=SEED, keep_host=True,
                            alias=True, device="cpu")
    j = JTable(jg, cap=CAP, seed=SEED, keep_host=True, alias=True)
    est = BaseEstimator(_Probe(), {"checkpoint_steps": 0}, device="cpu")
    est.static_batch.update(p.tables)
    before = {k: v.clone() for k, v in p.tables.items()}
    pg.apply_delta(**DELTA)
    jg.apply_delta(**DELTA)
    got = p.patch_rows(pg, delta_dirty_ids(**DELTA))
    want = j.patch_rows(jg, j_dirty(**DELTA))
    assert got == want
    assert got["upload"] == "replace" and got["grown_rows"] == 2
    _same_tables(p, j)
    scratch = DeviceNeighborTable(_builder(GraphBuilder, final=True)
                                  .finalize(), cap=CAP, seed=SEED,
                                  keep_host=True, alias=True, device="cpu")
    for a, b in zip(_tables(p), _tables(scratch)):
        assert a.tobytes() == b.tobytes()
    for k, old in before.items():
        assert est.static_batch[k] is not p.tables[k]
        assert torch.equal(est.static_batch[k], old)
        assert est.static_batch[k].data_ptr() != p.tables[k].data_ptr()


def test_patch_rows_edge_only_scatters_into_new_tensors():
    """The reference's edge-only case: no growth, "row_scatter", the
    untouched rows bit-copied, the device tensors equal to the host
    copies and to a build from scratch, byte for byte with the
    reference's; the tensors are new (clones with the dirty rows
    written), the old ones and an estimator's merged view unchanged;
    merging the new ones changes what the estimator reads."""
    pg, jg = _builder(GraphBuilder).finalize(), _builder(JBuilder).finalize()
    p = DeviceNeighborTable(pg, cap=CAP, seed=SEED, keep_host=True,
                            alias=True, device="cpu")
    j = JTable(jg, cap=CAP, seed=SEED, keep_host=True, alias=True)
    est = BaseEstimator(_Probe(), {"checkpoint_steps": 0}, device="cpu")
    est.static_batch.update(p.tables)
    old = {k: (v, v.clone()) for k, v in p.tables.items()}
    pg.apply_delta(**EDGE_ONLY)
    jg.apply_delta(**EDGE_ONLY)
    got = p.patch_rows(pg, delta_dirty_ids(**EDGE_ONLY))
    assert got == j.patch_rows(jg, j_dirty(**EDGE_ONLY))
    assert got["upload"] == "row_scatter" and got["grown_rows"] == 0
    assert got["rows_patched"] == 2
    _same_tables(p, j)
    rows = pg.node_rows(np.array([3, 5], np.uint64))
    untouched = np.ones(p.pad_row + 1, bool)
    untouched[rows] = False
    for k, (tensor, clone) in old.items():
        assert est.static_batch[k] is tensor and torch.equal(tensor, clone)
        assert p.tables[k] is not tensor
        assert torch.equal(p.tables[k][untouched], clone[untouched])
    assert np.array_equal(p.neighbors.numpy(), p.host_tables[0])
    assert np.array_equal(p.cum_weights.numpy(), p.host_tables[1])
    scratch = DeviceNeighborTable(pg, cap=CAP, seed=SEED, alias=True,
                                  device="cpu")
    for a, b in zip(_tables(p), _tables(scratch)):
        assert a.tobytes() == b.tobytes()
    assert not torch.equal(old["nbr_table"][1][rows],
                           p.neighbors[rows])
    est.static_batch.update(p.tables)
    assert est.static_batch["nbr_table"] is p.neighbors


def test_patch_rows_of_unknown_ids_uploads_nothing():
    """Ids the graph does not know drop out: an empty patch, "none",
    the same tensors, as the reference's stats say."""
    pg, jg = _builder(GraphBuilder).finalize(), _builder(JBuilder).finalize()
    p = DeviceNeighborTable(pg, cap=CAP, seed=SEED, device="cpu")
    j = JTable(jg, cap=CAP, seed=SEED)
    nbr = p.neighbors
    unknown = np.array([999, 1000], np.uint64)
    got = p.patch_rows(pg, unknown)
    assert got == j.patch_rows(jg, unknown)
    assert got["upload"] == "none" and got["rows_patched"] == 0
    assert p.neighbors is nbr


def test_patch_rows_refuses_the_fused_and_sharded_layouts():
    """The fused and the row-sharded layouts raise the reference's
    ValueError, in both packages."""
    pg, jg = _builder(GraphBuilder).finalize(), _builder(JBuilder).finalize()
    for layout in ({"fused": True}, {"shard_rows": True}):
        for t, g in ((DeviceNeighborTable(pg, cap=CAP, device="cpu",
                                          **layout), pg),
                     (JTable(jg, cap=CAP, **layout), jg)):
            with pytest.raises(ValueError, match="replicated split"):
                t.patch_rows(g, np.array([1], np.uint64))


def test_alias_rows_counters_match_the_reference():
    """alias_rows_rebuilt_total grows by the rows of a full alias build,
    alias_rows_patched_total by the rows a patch re-derives, in both
    packages alike."""
    names = ("alias_rows_rebuilt_total", "alias_rows_patched_total")
    deltas = []
    for reg, builder, table, dirty, kw in (
            (obs, GraphBuilder, DeviceNeighborTable, delta_dirty_ids,
             {"device": "cpu"}),
            (j_obs, JBuilder, JTable, j_dirty, {})):
        g = _builder(builder).finalize()
        start = [_counter(reg, n) for n in names]
        t = table(g, cap=CAP, seed=SEED, alias=True, **kw)
        g.apply_delta(**DELTA)
        t.patch_rows(g, dirty(**DELTA))
        deltas.append([_counter(reg, n) - s for n, s in zip(names, start)])
    assert deltas[0] == deltas[1] == [41, 6]


class _Cache:
    """A duck-typed out-of-band cache."""

    def __init__(self):
        self.calls = 0

    def maybe_invalidate(self):
        self.calls += 1

    def cache_stats(self):
        return {"calls": self.calls}


def test_streaming_driver_apply_delta_matches_the_reference():
    """apply_delta's dict (epoch, dirty count, the table's stats, the
    caches' stats) and the counters it moves equal the reference's."""
    names = ("streaming_deltas_total", "streaming_deltas_refused_total",
             "streaming_exports_total", "streaming_swaps_total")
    outs, moved = [], []
    for reg, builder, table, driver, kw in (
            (obs, GraphBuilder, DeviceNeighborTable, StreamingDriver,
             {"device": "cpu"}),
            (j_obs, JBuilder, JTable, JDriver, {})):
        g = _builder(builder).finalize()
        t = table(g, cap=CAP, seed=SEED, keep_host=True, alias=True, **kw)
        start = [_counter(reg, n) for n in names]
        d = driver(None, g, device_table=t, caches=[_Cache()])
        outs.append([d.apply_delta(**DELTA), d.apply_delta(**EDGE_ONLY)])
        moved.append([_counter(reg, n) - s for n, s in zip(names, start)])
        assert reg.default_registry().gauge(
            "streaming_graph_epoch").value == 2
    assert outs[0] == outs[1]
    assert [o["epoch"] for o in outs[0]] == [1, 2]
    assert [o["table"]["upload"] for o in outs[0]] == ["replace",
                                                      "row_scatter"]
    assert outs[0][1]["caches"] == [{"calls": 2}]
    assert moved[0] == moved[1] == [2, 0, 0, 0]


class _Tiny(torch.nn.Module):
    """The reference test's Tiny: a Dense(2) and the mean square of its
    output as the loss."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(3, 2)

    def forward(self, batch):
        v = self.dense(batch["x"])
        loss = (v ** 2).mean()
        return ModelOutput(v, loss, "l", loss)


def _ones():
    while True:
        yield {"x": np.ones((4, 3), np.float32)}


def test_streaming_driver_fine_tune_offsets_max_steps():
    """fine_tune(2) after 3 steps trains to step 5 (train's max_steps is
    the global step to reach), as the reference's test has it."""
    est = BaseEstimator(_Tiny(), {"log_steps": 1000,
                                  "checkpoint_steps": 0}, device="cpu")
    est.train(_ones(), max_steps=3)
    assert est.step == 3
    driver = StreamingDriver(est, _builder(GraphBuilder).finalize())
    out = driver.fine_tune(2, input_fn=_ones())
    assert est.step == 5 and out["global_step"] == 5
    with pytest.raises(ValueError, match="export_dir"):
        driver.export_and_swap()


class _RefusingEngine:
    def apply_delta(self, **delta):
        raise EngineError("wal append failed: disk full")


def test_streaming_driver_counts_a_refused_delta():
    """An engine whose write-ahead log refuses the delta: the error
    surfaces and streaming_deltas_refused_total counts it."""
    name = "streaming_deltas_refused_total"
    start = _counter(obs, name)
    driver = StreamingDriver(None, _RefusingEngine())
    with pytest.raises(EngineError, match="wal"):
        driver.apply_delta(**EDGE_ONLY)
    assert _counter(obs, name) == start + 1


class _FeatEmb(torch.nn.Module):
    """The reference acceptance test's FeatEmb: proj = Dense(dim) of the
    node's 3-dim feature, an MSE against the sum of its first dim - 1
    components."""

    def __init__(self, dim: int = 4):
        super().__init__()
        self.dim = dim
        self.proj = torch.nn.Linear(3, dim)

    def forward(self, batch):
        v = self.proj(batch["feat"])
        target = batch["feat"][:, :self.dim - 1].sum(-1, keepdim=True)
        loss = ((v - target) ** 2).mean()
        return ModelOutput(v, loss, "mse", loss)


def test_streaming_round_serves_a_node_that_did_not_exist(tmp_path):
    """The reference's acceptance round (tests/test_streaming.py:752-827)
    in the port: a 32-node graph, 3 training steps, bundle v1 in an
    InferenceServer; one round adds node 901 and an edge to node 1,
    fine-tunes 3 steps, exports v2 and swaps it in. The fleet then
    serves v2 with one more id, and its kNN returns node 901, which v1
    did not hold."""
    from euler_tpu_torch.serving import InferenceServer, ServingClient

    g = _builder(GraphBuilder, n=32).finalize()
    B = 8

    def train_fn():
        while True:
            ids = g.sample_node(B, -1)
            yield {"feat": g.get_dense_feature(ids, "feat"),
                   "infer_ids": ids}

    def sweep_fn():
        ids = g.all_node_ids()          # read at call time: post-delta
        for i in range(0, len(ids), B):
            part = ids[i:i + B]
            if len(part) < B:
                part = np.concatenate(
                    [part, np.full(B - len(part), part[-1], np.uint64)])
            yield {"feat": g.get_dense_feature(part, "feat"),
                   "infer_ids": part}

    est = BaseEstimator(_FeatEmb(), {"log_steps": 1000,
                                     "checkpoint_steps": 0}, device="cpu")
    est.train(train_fn(), max_steps=3)
    root = str(tmp_path / "bundles")
    v1 = est.export_bundle(f"{root}/v1", input_fn=sweep_fn, nlist=2,
                           nprobe=2, version="v1")
    new_id = np.uint64(901)
    assert v1.ids.max() < new_id
    names = ("streaming_deltas_total", "streaming_exports_total",
             "streaming_swaps_total")
    start = [_counter(obs, n) for n in names]
    with InferenceServer(f"{root}/v1", service="stream_port", replica=0,
                         max_batch=8, device="cpu") as srv, \
            ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}",
                          service="stream_port") as cli:
        driver = StreamingDriver(est, g, serving_client=cli,
                                 export_dir=root)
        out = driver.round(
            {"node_ids": np.array([new_id], np.uint64),
             "edge_src": np.array([new_id], np.uint64),
             "edge_dst": np.array([1], np.uint64)},
            steps=3, train_input_fn=train_fn(), version="v2",
            input_fn=sweep_fn, nlist=2, nprobe=2)
        assert out["delta"]["epoch"] == 1 and out["delta"]["dirty"] == 2
        assert out["train"]["global_step"] == 6
        assert out["swap"] is not None and out["version"] == "v2"
        info = cli.info()
        assert info["bundle_version"] == "v2"
        assert info["count"] == len(v1.ids) + 1
        nbr_ids, _ = cli.knn(np.array([new_id], np.uint64),
                             k=int(info["count"]))
        assert new_id in nbr_ids[0]
    assert [_counter(obs, n) - s for n, s in zip(names, start)] == [1, 1, 1]
