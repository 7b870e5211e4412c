"""The port's graph service (gql.start_service / start_registry, the
`tcp:` registry) and its clients (graph/remote.py RemoteGraphEngine,
graph/pipeline.py PipelinedClient and CachedGraphEngine, graph/chaos.py,
graph/elastic.py) against the JAX package's, on the CPU.

One graph is dumped once as 2 partitions and served twice in this
module: by two shards of the port's engine behind the port's `tcp:`
registry, and by two shards of the reference's behind the reference's.
The clients of either package find either cluster (the two builds speak
one wire, rpc.cc), so both wire directions are held. Deterministic
reads (full neighbors, features, types, edges) are held to the embedded
engine byte for byte, serial, pooled and through the cache cold and
warm. Draws run on the shards' threads, so a remote draw is held by
membership and proportions, as tests/test_gql.py holds it. Tests that
stop a shard or apply a delta start clusters of their own (a dump and
two shards take milliseconds here)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)

import random
import threading
import time

import numpy as np
import pytest

from euler_tpu import gql as J_gql
from euler_tpu.graph import GraphBuilder as JGraphBuilder
from euler_tpu.graph import chaos as J_chaos
from euler_tpu.graph import elastic as J_elastic
from euler_tpu.graph import pipeline as J_pipeline
from euler_tpu.graph import remote as J_remote
from euler_tpu.graph import seed as j_seed
from euler_tpu_torch import gql as P_gql
from euler_tpu_torch.estimator.retry import EngineError
from euler_tpu_torch.graph import GraphBuilder
from euler_tpu_torch.graph import chaos as P_chaos
from euler_tpu_torch.graph import elastic as P_elastic
from euler_tpu_torch.graph import pipeline as P_pipeline
from euler_tpu_torch.graph import remote as P_remote
from euler_tpu_torch.graph import seed as p_seed

N, E, D, C = 48, 300, 4, 3


def _build(builder_cls, seed_fn, n=N, e=E):
    """A typed, weighted graph with dense, sparse and edge features and
    one-hot labels, from a numpy seed."""
    seed_fn(11)
    rng = np.random.default_rng(11)
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b = builder_cls()
    b.set_num_types(2, 2)
    b.set_feature(0, 0, D, "feature")
    b.set_feature(1, 0, C, "label")
    b.set_feature(2, 1, 0, "tags")
    b.set_feature(0, 0, 2, "e_dense", edge=True)
    b.add_nodes(ids, types=(ids % 2).astype(np.int32),
                weights=rng.uniform(0.5, 4.0, n).astype(np.float32))
    # a ring (every node has a neighbor) plus random edges
    src = np.concatenate([ids, ids[rng.integers(0, n, e - n)]])
    dst = np.concatenate([np.roll(ids, -1), ids[rng.integers(0, n, e - n)]])
    et = rng.integers(0, 2, e).astype(np.int32)
    w = rng.uniform(0.1, 3.0, e).astype(np.float32)
    b.add_edges(src, dst, types=et, weights=w)
    b.set_node_dense(ids, 0, rng.normal(size=(n, D)).astype(np.float32))
    b.set_node_dense(ids, 1, np.eye(C, dtype=np.float32)[
        (ids % C).astype(np.int64)])
    b.set_node_sparse(ids, 2, np.arange(n + 1, dtype=np.uint64) * 2,
                      rng.integers(0, 99, 2 * n).astype(np.uint64))
    b.set_edge_dense(src, dst, et, 0, np.stack([w, -w], 1))
    return b.finalize()


class _Cluster:
    """Two shards of one package's engine behind its own tcp: registry."""

    def __init__(self, gql, data_dir):
        self.gql, self.data_dir = gql, data_dir
        self.registry = gql.start_registry()
        self.spec = f"tcp:127.0.0.1:{self.registry.port}"
        self.shards = [self.start(i) for i in range(2)]

    def start(self, i):
        return self.gql.start_service(self.data_dir, shard_idx=i,
                                      shard_num=2, registry_dir=self.spec)

    def stop(self):
        for s in self.shards:
            s.stop()
        self.registry.stop()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pg, jg = _build(GraphBuilder, p_seed), _build(JGraphBuilder, j_seed)
    d = str(tmp_path_factory.mktemp("ring") / "g")
    pg.dump(d, num_partitions=2)
    port = ref = None
    try:
        port, ref = _Cluster(P_gql, d), _Cluster(J_gql, d)
        yield {"pg": pg, "jg": jg, "port": port, "ref": ref, "dir": d}
    finally:
        for c in (port, ref):
            if c is not None:
                c.stop()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


def _reads(g, ids):
    """Every deterministic read of the engine API, flattened. (In-edge
    lists are not among them: a shard holds the edges of the nodes it
    owns, so a cluster's getRNB answers each shard's share, in both
    packages; test_reads_cross_the_wire_both_ways holds those.)"""
    out = []
    for kw in ({}, {"edge_types": [1]}, {"sorted_by_id": True}):
        out += list(g.get_full_neighbor(ids, **kw))
    out.append(g.get_dense_feature(ids, "feature"))
    out += list(g.get_dense_feature(ids, ["label", "feature"], [C, D]))
    out.append(g.get_node_type(ids))
    out += list(g.get_sparse_feature(ids, "tags"))
    out += list(g.get_neighbor_edges(ids))
    off, src, dst, et, _ = g.get_neighbor_edges(ids[:8])
    out.append(g.get_edge_dense_feature(src, dst, et, "e_dense"))
    return out


def _ids():
    # every node, shuffled, a duplicate and an unknown id
    rng = np.random.default_rng(3)
    ids = rng.permutation(np.arange(1, N + 1, dtype=np.uint64))
    return np.concatenate([ids, ids[:3], np.array([N + 500], np.uint64)])


@pytest.mark.parametrize("client", ["serial", "pooled", "cached"])
def test_remote_reads_match_the_embedded_engine(world, client):
    """Through the port's registry and shards: the serial client, the
    pooled one (chunks of 16 ids, merged in order) and the cache over
    it, read cold then warm, answer as the embedded engine does."""
    ids = _ids()
    want = _reads(world["pg"], ids)
    eng = P_remote.RemoteGraphEngine(
        world["port"].spec, seed=5, pool_size=0 if client == "serial" else 2,
        chunk_size=16)
    g = P_pipeline.CachedGraphEngine(eng) if client == "cached" else eng
    try:
        for _ in range(2 if client == "cached" else 1):
            for a, b in zip(_reads(g, ids), want, strict=True):
                _same(a, b)
        if client == "cached":
            st = g.cache_stats()
            assert st["hits"] > 0 and st["misses"] > 0
            assert st["poison_skips"] == 0 and st["inserts"] > 0
    finally:
        g.close()


@pytest.mark.parametrize("direction", ["port_client_ref_shards",
                                       "ref_client_port_shards"])
def test_reads_cross_the_wire_both_ways(world, direction):
    """A port client of the reference's registry and shards, and a
    reference client of the port's, read what the embedded engine
    holds, and the two clients' cached reads agree with each other."""
    ids = _ids()
    if direction == "port_client_ref_shards":
        eng = P_remote.RemoteGraphEngine(world["ref"].spec, seed=5)
        cached = P_pipeline.CachedGraphEngine(eng)
        other = P_remote.RemoteGraphEngine(world["port"].spec, seed=5)
    else:
        eng = J_remote.RemoteGraphEngine(world["port"].spec, seed=5)
        cached = J_pipeline.CachedGraphEngine(eng)
        other = J_remote.RemoteGraphEngine(world["ref"].spec, seed=5)
    try:
        want = _reads(world["pg"], ids)
        for g in (eng, cached, other):
            for a, b in zip(_reads(g, ids), want, strict=True):
                _same(a, b)
        for a, b in zip(eng.get_full_neighbor(ids, in_edges=True),
                        other.get_full_neighbor(ids, in_edges=True),
                        strict=True):
            _same(a, b)
        assert sorted(P_gql.scan_registry(world["port"].spec)) == [0, 1]
        assert sorted(J_gql.scan_registry(world["port"].spec)) == [0, 1]
    finally:
        cached.close()
        other.close()


def test_remote_draws_are_true_neighbors(world):
    """Draws run on the shards' threads: each hop of a remote
    sample_fanout, sample_neighbor, random_walk and sample_layerwise
    holds only true neighbors (the embedded engine's full lists), at
    the embedded engine's shapes; sample_node's proportions follow the
    node weights as closely as the reference client's do."""
    pg = world["pg"]
    eng = P_remote.RemoteGraphEngine(world["port"].spec, seed=5,
                                     pool_size=2, chunk_size=16)
    ref = J_remote.RemoteGraphEngine(world["port"].spec, seed=5)
    try:
        roots = _ids()[:40]
        off, nbr, _, _ = pg.get_full_neighbor(
            np.arange(1, N + 1, dtype=np.uint64))
        true = {i + 1: set(nbr[off[i]:off[i + 1]].tolist())
                for i in range(N)}
        ids, w, t = eng.sample_fanout(roots, [3, 2])
        assert [a.shape for a in ids] == [(120,), (240,)]
        parents = [np.repeat(roots, 3), np.repeat(ids[0], 2)]
        for hop, par in zip(ids, parents):
            assert all(int(c) in true[int(p)] for c, p in zip(hop, par))
        nb, _, _ = eng.sample_neighbor(roots, 4)
        assert nb.shape == (40, 4)
        assert all(set(row.tolist()) <= true[int(r)]
                   for r, row in zip(roots, nb))
        walks = eng.random_walk(roots[:8], 3)
        assert walks.shape == (8, 4)
        for row in walks:
            assert all(int(b) in true[int(a)] for a, b in zip(row, row[1:]))
        pool = eng.sample_layerwise(roots[:4], [16])[0]
        cand = set().union(*(true[int(r)] for r in roots[:4]))
        assert pool.shape == (16,) and set(pool.tolist()) <= cand
        counts = [np.bincount(e.sample_node(4096).astype(np.int64),
                              minlength=N + 1)[1:] / 4096.0
                  for e in (eng, ref)]
        assert np.abs(counts[0] - counts[1]).max() < 0.03
    finally:
        eng.close()
        ref.close()


def _cache_round(pkg_remote, pkg_pipeline, spec):
    eng = pkg_remote.RemoteGraphEngine(spec, seed=3)
    cache = pkg_pipeline.CachedGraphEngine(eng, budget_bytes=1 << 20)
    try:
        a = np.arange(1, 21, dtype=np.uint64)
        b = np.arange(11, 31, dtype=np.uint64)
        reads = []
        for ids in (a, a, b):
            reads += list(cache.get_full_neighbor(ids))
            reads.append(cache.get_dense_feature(ids, "feature"))
        before = cache.cache_stats()
        epoch = cache.apply_delta(edge_src=np.array([5, 6], np.uint64),
                                  edge_dst=np.array([7, 40], np.uint64))
        reads += list(cache.get_full_neighbor(b))
        reads.append(cache.get_dense_feature(a, "feature"))
        return before, cache.cache_stats(), epoch, reads
    finally:
        cache.close()


def test_cache_counters_and_epoch_eviction_match_the_reference(world,
                                                               tmp_path):
    """The same reads and the same delta through each package's cache
    over each package's own fresh cluster: equal hit / miss / insert /
    evict counters, the same surgical epoch eviction (only the delta's
    dirty ids leave the cache) and the same post-delta bytes."""
    clusters = []
    try:
        runs = []
        for gql, rem, pipe in ((P_gql, P_remote, P_pipeline),
                               (J_gql, J_remote, J_pipeline)):
            d = str(tmp_path / gql.__name__)
            world["pg"].dump(d, num_partitions=2)
            clusters.append(_Cluster(gql, d))
            runs.append(_cache_round(rem, pipe, clusters[-1].spec))
        (pb, pa, pe, pr), (jb, ja, je, jr) = runs
        assert pb == jb and pa == ja and pe == je == 1
        assert pa["epoch_evicted"] > 0 and pa["epoch_retained"] > 0
        assert pa["epoch_flushes"] == 0
        for x, y in zip(pr, jr, strict=True):
            _same(x, y)
    finally:
        for c in clusters:
            c.stop()


def _chaos_trace(chaos, g):
    plan = chaos.ChaosPlan(seed=9, error_rate=0.25, truncate_rate=0.2,
                           flap_period=7, flap_down=1, fail_calls=(3,))
    eng = chaos.ChaosGraphEngine(g, plan)
    out = []
    for i in range(40):
        try:
            r = eng.get_dense_feature(np.arange(1, 9, dtype=np.uint64),
                                      "feature")
            out.append(r.shape[0])
        except Exception as e:  # the injected transport error
            out.append(str(e))
    return out, eng.stats()


def test_chaos_schedule_matches_the_reference(world):
    got = _chaos_trace(P_chaos, world["pg"])
    want = _chaos_trace(J_chaos, world["jg"])
    assert got == want
    assert got[1]["errors"] > 0 and got[1]["truncated"] > 0


@pytest.mark.parametrize("spec", ["e1-P4-0.1.0.1", "e3-P4-0.1.2.2+3",
                                  "e7-P2-1+0.0"])
def test_ownership_maps_match_the_reference(world, spec):
    """decode / encode / split / add_replica / owner_of give the
    reference's maps, and a map the port publishes in a tcp: registry
    is the one the reference fetches (and the other way round)."""
    pm, jm = P_elastic.OwnershipMap.decode(spec), \
        J_elastic.OwnershipMap.decode(spec)
    for m_p, m_j in ((pm, jm), (pm.split(pm.shard_num + 2),
                                jm.split(jm.shard_num + 2)),
                     (pm.add_replica(1, 3), jm.add_replica(1, 3))):
        assert m_p.encode() == m_j.encode()
        assert m_p.shard_num == m_j.shard_num
        assert [m_p.owner_of(i) for i in range(9)] == \
            [m_j.owner_of(i) for i in range(9)]
    assert P_elastic.OwnershipMap.default(3, 2).encode() == \
        J_elastic.OwnershipMap.default(3, 2).encode()
    for bad in ("e0-P1-0", "x1-P1-0", "e1-P2-0"):
        with pytest.raises(ValueError):
            P_elastic.OwnershipMap.decode(bad)
    reg = world["port"].spec
    try:
        P_elastic.publish_map(reg, pm, service="t")
        assert J_elastic.fetch_map(reg, service="t").encode() == spec
        J_elastic.publish_map(reg, jm.add_replica(0, 1), service="t")
        assert P_elastic.fetch_map(reg, service="t").encode() == \
            jm.add_replica(0, 1).encode()
    finally:
        P_elastic.remove_map_entries(reg, service="t")
    assert P_elastic.fetch_map(reg, service="t") is None
    assert P_elastic.hottest_shard({0: 1, 1: 3}) == \
        J_elastic.hottest_shard({0: 1, 1: 3})


def test_retry_policy_and_rpc_config_match_the_reference():
    for kw in ({}, {"base_backoff_s": 0.5, "max_backoff_s": 1.0}):
        a, b = P_remote.RetryPolicy(**kw), J_remote.RetryPolicy(**kw)
        assert a.__dict__ == b.__dict__
        ra, rb = random.Random(3), random.Random(3)
        assert [a.backoff_s(i, ra) for i in range(1, 9)] == \
            [b.backoff_s(i, rb) for i in range(1, 9)]
    for msg in ("rpc to h:1 failed after retries", "parse error",
                "chaos: x", "stale ownership map", "unknown feature"):
        assert P_remote.retryable_error(EngineError(msg)) == \
            J_remote.retryable_error(J_remote.EngineError(msg))
    assert P_remote.configure_rpc() == J_remote.configure_rpc()
    assert set(P_remote.rpc_transport_stats()) == \
        set(J_remote.rpc_transport_stats())


def _tiny_dump(d):
    """tests/test_gql.py:test_shard_failure_during_training's graph."""
    p_seed(11)
    rng = np.random.default_rng(11)
    n, c = 30, 3
    b = GraphBuilder()
    b.set_num_types(1, 1)
    b.set_feature(0, 0, D, "feature")
    b.set_feature(1, 0, c, "label")
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b.add_nodes(ids)
    b.add_edges(np.concatenate([ids, ids]),
                np.concatenate([np.roll(ids, -1), np.roll(ids, -3)]))
    b.set_node_dense(ids, 0, rng.normal(0, 1, (n, D)).astype(np.float32))
    b.set_node_dense(ids, 1, np.eye(c, dtype=np.float32)[
        (ids % c).astype(np.int64)])
    b.finalize().dump(d, num_partitions=2)


def test_training_survives_a_shard_restart(tmp_path):
    """A port NodeEstimator trains from a 2-shard cluster found through
    a tcp: registry; shard 0 stops after 3 steps and comes back on a new
    port 0.5 s later, while the feeder retries; training reaches its
    step count with a finite loss only after the restart. With shard 0
    down, a client whose deadline runs out raises (degrade=False) or
    pads and counts the batch (degrade=True)."""
    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.models.graphsage import SupervisedGraphSage

    d = str(tmp_path / "g")
    _tiny_dump(d)
    cl = _Cluster(P_gql, d)
    remote = P_remote.RemoteGraphEngine(
        cl.spec, seed=5, retry_policy=P_remote.RetryPolicy(
            deadline_s=60, max_backoff_s=0.2))
    probes = []
    timeline = {}
    try:
        flow = FanoutDataFlow(remote, [3, 2], feature_ids=["feature"])
        est = NodeEstimator(
            SupervisedGraphSage(3, D, multilabel=False, dim=8,
                                fanouts=(3, 2)),
            dict(batch_size=8, learning_rate=0.05, log_steps=1000,
                 checkpoint_steps=0),
            remote, flow, label_fid="label", label_dim=3, device="cpu")
        for degrade in (False, True):
            probes.append(P_remote.RemoteGraphEngine(
                cl.spec, seed=5, degrade=degrade,
                retry_policy=P_remote.RetryPolicy(deadline_s=0.2)))
        it = est.train_input_fn()
        assert est.train(it, max_steps=3)["global_step"] == 3
        cl.shards[0].stop()
        timeline["down_at"] = time.monotonic()
        with pytest.raises(P_remote.RetryDeadlineExceeded):
            probes[0].sample_fanout(np.arange(1, 5, dtype=np.uint64), [2])
        ids, _, _ = probes[1].sample_fanout(
            np.arange(1, 5, dtype=np.uint64), [2])
        assert (ids[0] == 0).all() and probes[1].health()["degraded"] == 1

        def revive():
            time.sleep(0.5)
            cl.shards[0] = cl.start(0)
            timeline["up_at"] = time.monotonic()

        t = threading.Thread(target=revive)
        t.start()
        try:
            res = est.train(it, max_steps=6)
            done_at = time.monotonic()
        finally:
            t.join()
        assert res["global_step"] == 6 and np.isfinite(res["loss"])
        assert done_at >= timeline["up_at"] > timeline["down_at"]
        assert remote.health()["failovers"] >= 1
        assert remote.sample_node(4, -1).shape == (4,)
    finally:
        for p in probes:
            p.close()
        remote.close()
        cl.stop()


@pytest.mark.parametrize("target", ["data", "endpoints"])
def test_console_prints_what_the_reference_prints(world, target,
                                                  monkeypatch, capsys):
    """tools/console.py over the dump (embedded) or the port's cluster
    (its tcp: registry): the same session (a `let`, a deterministic
    chain, an error, `inputs`) prints what the reference's console
    prints, and a one-shot query returns 0."""
    from euler_tpu.tools import console as J_console
    from euler_tpu_torch.tools import console as P_console

    argv = (["--data", world["dir"]] if target == "data"
            else ["--endpoints", world["port"].spec])
    session = ["let r u64 1,2,5", "v(r).getNB(*).as(nb)",
               "v(r).values(feature).as(f)", "v(r).bogus(1)", "inputs",
               "quit"]
    printed = []
    for mod in (P_console, J_console):
        lines = iter(session)
        monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
        assert mod.main(argv) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert "nb:1: uint64[" in printed[0] and "error:" in printed[0]
    assert P_console.main([*argv, "-q", "sampleN(-1, 4).as(n)"]) == 0
