"""The port's serving stack over the wire, against the JAX package's, on
the CPU (`device="cpu"`, sockets on 127.0.0.1 port 0, `dir:` registries
under tmp_path): each package's client against the other's server, the
client's request frames byte for byte, a 2-shard fleet's scatter-gather
against brute_force, a hot-swap under traffic, explicit shedding, drain
and stop, the autoscaler, and the padded shapes behind the ladder.

Tolerances: embed is exact and knn byte-identical (the same host numpy
on the same bytes); score sums D = 32 float32 products on the device in
torch's order where the reference sums them in XLA's, so it is held to
rtol 1e-5, atol 1e-5 (a few ulps of values of order 10).
"""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import socket
import threading
import time

import numpy as np
import pytest

from euler_tpu import serving as ref_serving
from euler_tpu.serving import wire as ref_wire
from euler_tpu_torch import serving
from euler_tpu_torch.estimator.retry import (
    RetryDeadlineExceeded, RetryPolicy,
)
from euler_tpu_torch.serving import wire
from euler_tpu_torch.tools.knn import IVFFlatIndex, brute_force

pytestmark = [pytest.mark.serving, pytest.mark.serving_fleet]

N, D = 2000, 32
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_S = 30.0


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    ids = np.arange(N, dtype=np.uint64) * 3 + 5  # non-contiguous ids
    return emb, ids


def _save(tmp_path, name, seed=0, version="v1", shards=1):
    emb, ids = _arrays(seed)
    b = serving.ModelBundle({}, emb, ids, meta={"bundle_version": version})
    out = str(tmp_path / name)
    if shards > 1:
        return b.save_sharded(out, shards, nlist=8, nprobe=2)
    idx = IVFFlatIndex(nlist=8, nprobe=2)
    idx.train_add(emb, ids)
    b.index_state = idx.state_dict()
    return b.save(out)


def _queries(ids, rng, n=8):
    """n ids of the table and, in every other request, an unknown one."""
    q = rng.choice(ids, n).astype(np.uint64)
    if rng.random() < 0.5:
        q[rng.integers(n)] = np.uint64(4)  # below every id: unknown
    return q


def _want(emb, ids, q):
    rows = np.searchsorted(ids, q).clip(0, len(ids) - 1)
    valid = ids[rows] == q
    out = emb[rows].copy()
    out[~valid] = 0.0
    return out


def _port_server(bundle, **kw):
    return serving.InferenceServer(bundle, device="cpu", max_batch=16,
                                   flush_ms=1.0, **kw)


def _client(pkg, **kw):
    mod = serving if pkg == "port" else ref_serving
    return mod.ServingClient(**kw)


@pytest.mark.parametrize("client", ["port", "reference"])
def test_servers_answer_alike_across_the_wire(tmp_path, client):
    """One client (either package's) against the port's server and the
    reference's on one bundle: embed exact and equal to the bundle's rows
    (unknown ids zero), knn byte-identical to brute_force and to each
    other (exact and through the stored IVF index), score within
    SCORE_TOL of numpy's dots; info alike; the port server's padded
    shapes stay within its ladder."""
    d = _save(tmp_path, "b")
    emb, ids = _arrays()
    bundle = serving.ModelBundle.load(d)
    index = IVFFlatIndex.from_state(bundle.index_state, emb, ids)
    # a service of its own: the obs counters are per process and label
    port = _port_server(d, service=f"alike_{client}")
    ref = ref_serving.InferenceServer(d, service=f"alike_{client}",
                                      max_batch=16, flush_ms=1.0)
    clis = [_client(client, endpoints=f"hosts:127.0.0.1:{s.port}")
            for s in (port, ref)]
    try:
        rng = np.random.default_rng(1)
        for _ in range(6):
            q = _queries(ids, rng)
            want = _want(emb, ids, q)
            answers = []
            for cli in clis:
                got = cli.embed(q)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
                nbr, sims = cli.knn(q, k=10)
                w_nbr, w_sims = brute_force(emb, ids, want, 10)
                assert np.array_equal(nbr, w_nbr)
                assert np.array_equal(sims, w_sims)
                a_nbr, a_sims = cli.knn(q, k=5, exact=False)
                i_nbr, i_sims = index.search(want, 5)
                assert np.array_equal(a_nbr, i_nbr)
                assert np.array_equal(a_sims, i_sims)
                dst = np.roll(q, 3)
                sc = cli.score(q, dst)
                np.testing.assert_allclose(
                    sc, np.einsum("ij,ij->i", want, _want(emb, ids, dst)),
                    **SCORE_TOL)
                answers.append((nbr, sims, sc))
            assert np.array_equal(answers[0][0], answers[1][0])
            assert np.array_equal(answers[0][1], answers[1][1])
            np.testing.assert_allclose(answers[0][2], answers[1][2],
                                       **SCORE_TOL)
        infos = [cli.info() for cli in clis]
        for key in ("bundle_version", "dim", "count", "id_lo", "id_hi",
                    "shard", "num_shards", "model_spec"):
            assert infos[0][key] == infos[1][key], key
        healths = [cli.server_health() for cli in clis]
        assert set(healths[0]) == set(healths[1])
        assert healths[0]["unknown_ids"] == healths[1]["unknown_ids"] > 0
        shapes = port.padded_shapes_seen()
        assert 0 < max(shapes.values()) <= len(port.ladder)
    finally:
        for cli in clis:
            cli.close()
        port.stop()
        ref.stop()


class _Recorder:
    """A TCP proxy that records every request frame between a client
    and a server."""

    def __init__(self, upstream_port: int):
        self.requests = []
        self._up = upstream_port
        self._ls = socket.create_server(("127.0.0.1", 0))
        self.port = self._ls.getsockname()[1]
        self._threads = []
        self._accept = threading.Thread(target=self._loop, daemon=True)
        self._accept.start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._ls.accept()
            except OSError:
                return
            t = threading.Thread(target=self._pipe, args=(conn,),
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _pipe(self, conn):
        with conn, socket.create_connection(("127.0.0.1", self._up)) as up:
            while True:
                try:
                    msg, body = ref_wire.read_frame(conn)
                except (OSError, ref_wire.WireError):
                    return
                self.requests.append((msg, body))
                ref_wire.write_frame(up, msg, body)
                ref_wire.write_frame(conn, *ref_wire.read_frame(up))

    def close(self):
        try:
            # shutdown first: close() alone leaves accept() blocked
            self._ls.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._ls.close()
        self._accept.join(JOIN_S)
        assert not self._accept.is_alive()
        for t in self._threads:
            t.join(JOIN_S)
            assert not t.is_alive()


@pytest.mark.parametrize("verb", ["embed", "knn", "knn_approx", "score",
                                  "info", "health", "swap"])
def test_client_requests_are_byte_identical(tmp_path, verb):
    """Each package's client, through a recording proxy to the port's
    server: the same request frames, byte for byte, the client's own
    info probe included (the data verbs' leading u32 deadline_ms aside:
    each client stamps its own remaining budget, both within the 10 s
    default)."""
    d = _save(tmp_path, "b")
    d2 = _save(tmp_path, "b2", seed=1, version="v2")
    _, ids = _arrays()
    q = ids[[0, 7, 1999]].copy()
    srv = _port_server(d)
    recs = [_Recorder(srv.port) for _ in range(2)]
    try:
        for pkg, rec in zip(("port", "reference"), recs):
            with _client(pkg, endpoints=f"hosts:127.0.0.1:{rec.port}") as c:
                {"embed": lambda: c.embed(q),
                 "knn": lambda: c.knn(q, k=4),
                 "knn_approx": lambda: c.knn(q, k=4, exact=False),
                 "score": lambda: c.score(q, q[::-1].copy()),
                 "info": c.info, "health": c.server_health,
                 "swap": lambda: c.swap_fleet(d2)}[verb]()
    finally:
        for rec in recs:
            rec.close()
        srv.stop()
    got, want = (r.requests for r in recs)
    assert len(got) == len(want) >= 1
    data_verbs = (wire.MSG_EMBED, wire.MSG_KNN, wire.MSG_SCORE,
                  wire.MSG_KNN_VEC)
    for (m0, b0), (m1, b1) in zip(got, want):
        assert m0 == m1
        if m0 in data_verbs:
            for b in (b0, b1):
                assert 0 < int.from_bytes(b[:4], "little") <= 10_000
            b0, b1 = b0[4:], b1[4:]
        assert b0 == b1
    assert got[-1][0] == {"embed": wire.MSG_EMBED, "knn": wire.MSG_KNN,
                          "knn_approx": wire.MSG_KNN,
                          "score": wire.MSG_SCORE, "info": wire.MSG_INFO,
                          "health": wire.MSG_HEALTH,
                          "swap": wire.MSG_SWAP}[verb]


@pytest.mark.parametrize("client", ["port", "reference"])
def test_two_shard_fleet_scatter_gather_is_byte_identical(tmp_path,
                                                          client):
    """Two port shard replicas discovered through a dir: registry: 16
    knn requests (8 ids, k = 10, unknown ids among them) through either
    package's client merge byte-identical to brute_force over the
    unsharded table; embed routes by id range, exact; score within
    SCORE_TOL."""
    d = _save(tmp_path, "b", shards=2)
    emb, ids = _arrays()
    spec = f"dir:{tmp_path / 'reg'}"
    srvs = [_port_server(d, registry=spec, service="fl", shard=s)
            for s in range(2)]
    try:
        with _client(client, registry=spec, service="fl") as cli:
            assert cli.shards() == [0, 1]
            rng = np.random.default_rng(2)
            for _ in range(16):
                q = _queries(ids, rng)
                want = _want(emb, ids, q)
                nbr, sims = cli.knn(q, k=10)
                w_nbr, w_sims = brute_force(emb, ids, want, 10)
                assert np.array_equal(nbr, w_nbr)
                assert np.array_equal(sims, w_sims)
            np.testing.assert_array_equal(cli.embed(q), want)
            dst = ids[[1990, 3, 1000, 999, 5, 1500, 20, 1999]]
            np.testing.assert_allclose(
                cli.score(q, dst),
                np.einsum("ij,ij->i", want, _want(emb, ids, dst)),
                **SCORE_TOL)
            assert cli.health()["fanout"]["merges"] == 16
    finally:
        for s in srvs:
            s.stop()


def test_fleet_missing_a_shard_refuses_scatter_gather(tmp_path):
    d = _save(tmp_path, "b", shards=2)
    spec = f"dir:{tmp_path / 'reg'}"
    srv = _port_server(d, registry=spec, service="half", shard=0)
    try:
        with serving.ServingClient(registry=spec, service="half") as cli:
            with pytest.raises(wire.WireError, match="incomplete"):
                cli.knn(np.array([5], np.uint64), k=3)
    finally:
        srv.stop()


def test_hot_swap_under_traffic_loses_no_request(tmp_path):
    """Four client threads embed while the server is swapped to v2 over
    the wire: every request answers (no error, none lost), each answer
    is v1's rows or v2's, every request sent after the swap returned
    gets v2's, the version flips, and the swapped-in engine's padded
    shapes stay within the ladder."""
    d1 = _save(tmp_path, "v1")
    d2 = _save(tmp_path, "v2", seed=1, version="v2")
    (e1, ids), (e2, _) = _arrays(0), _arrays(1)
    srv = _port_server(d1, service="hotswap")
    mu = threading.Lock()
    stats = {"sent": 0, "ok": 0, "err": 0, "after": 0, "v1": 0, "v2": 0}
    swapped = threading.Event()
    stop = threading.Event()
    enough = threading.Event()
    bad = []

    def traffic(seed):
        rng = np.random.default_rng(seed)
        with serving.ServingClient(
                endpoints=f"hosts:127.0.0.1:{srv.port}") as cli:
            while not stop.is_set():
                q = rng.choice(ids, int(rng.integers(1, 12)))
                after = swapped.is_set()
                with mu:
                    stats["sent"] += 1
                try:
                    got = cli.embed(q)
                except Exception as e:  # a status, counted
                    with mu:
                        stats["err"] += 1
                    bad.append(repr(e))
                    continue
                v2 = np.array_equal(got, _want(e2, ids, q))
                v1 = np.array_equal(got, _want(e1, ids, q))
                with mu:
                    stats["ok"] += 1
                    stats["v2" if v2 else "v1"] += v1 or v2
                    if not (v1 or v2) or (after and not v2):
                        bad.append((after, v1, v2))
                    stats["after"] += after
                    if stats["after"] >= 40:
                        enough.set()

    threads = [threading.Thread(target=traffic, args=(i,), daemon=True)
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        while stats["ok"] < 40 and time.monotonic() < deadline:
            time.sleep(0.005)
        with serving.ServingClient(
                endpoints=f"hosts:127.0.0.1:{srv.port}") as admin:
            (reply,) = admin.swap_fleet(d2).values()
        swapped.set()
        assert enough.wait(JOIN_S)
    finally:
        stop.set()
        for t in threads:
            t.join(JOIN_S)
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert stats["sent"] == stats["ok"] + stats["err"] and stats["err"] == 0
    assert stats["v1"] >= 40 and stats["v2"] >= 40
    assert reply["bundle_version"] == "v2"
    assert reply["previous_version"] == "v1"
    assert srv.bundle_version == "v2" and srv.health()["swaps"] == 1
    assert max(srv.padded_shapes_seen().values()) <= len(srv.ladder)


def test_overload_sheds_explicitly(tmp_path):
    """Eight simultaneous 8-id requests against a replica that takes one
    8-row flush at a time, 100 ms each, with 8 rows of queue: the ones
    admission refuses get an explicit SHED (ServerOverloaded after a
    single attempt), the rest their rows; every request ends with one
    of the two, and the server counts the sheds."""
    d = _save(tmp_path, "b")
    emb, ids = _arrays()
    srv = serving.InferenceServer(d, service="overload", device="cpu",
                                  max_batch=8, flush_ms=1.0, max_queue=8,
                                  inject_apply_latency_ms=100.0)
    gate = threading.Barrier(8)
    outcomes = []
    pol = RetryPolicy(deadline_s=0.0, call_timeout_s=10.0)

    def one(i):
        with serving.ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}",
                                   retry_policy=pol) as cli:
            q = ids[8 * i:8 * i + 8]
            gate.wait(JOIN_S)
            try:
                got = cli.embed(q)
                outcomes.append(("ok", np.array_equal(got, emb[8 * i:8 * i
                                                               + 8])))
            except serving.ServerOverloaded:
                outcomes.append(("shed", True))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        health = srv.health()
    finally:
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert len(outcomes) == 8 and all(ok for _, ok in outcomes)
    n_shed = sum(kind == "shed" for kind, _ in outcomes)
    assert n_shed >= 1 and health["shed"] == n_shed


def test_drain_deregisters_then_stops(tmp_path):
    """drain(): the registry entry goes first, queued work finishes, then
    the server stops; a client that found it through the registry then
    gets an explicit error, and stop() again is a no-op."""
    d = _save(tmp_path, "b")
    emb, ids = _arrays()
    spec = f"dir:{tmp_path / 'reg'}"
    srv = _port_server(d, registry=spec, service="dr")
    pol = RetryPolicy(deadline_s=0.5, call_timeout_s=2.0)
    with serving.ServingClient(registry=spec, service="dr",
                               retry_policy=pol) as cli:
        np.testing.assert_array_equal(cli.embed(ids[:3]), emb[:3])
        assert len(wire.discover_replicas(spec, "dr")) == 1
        srv.drain(grace_s=0.0, queue_timeout_s=2.0)
        assert wire.discover_replicas(spec, "dr") == []
        assert all(b.queue_depth == 0 for b in srv._batchers.values())
        with pytest.raises((wire.WireError, RetryDeadlineExceeded)):
            cli.embed(ids[:3])
    srv.stop()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", srv.port), timeout=2.0)


def test_autoscaler_steps_up_on_sheds_and_down_when_calm(tmp_path):
    """Eight closed-loop clients against one slow replica shed; the
    autoscaler's step() adds replicas (discovered through the dir:
    registry) up to max_replicas; with the load gone, one calm window
    drains one replica, and the fleet still answers exactly."""
    d = _save(tmp_path, "b")
    emb, ids = _arrays()
    spec = f"dir:{tmp_path / 'reg'}"
    kw = dict(device="cpu", max_batch=16, flush_ms=1.0, max_queue=32,
              inject_apply_latency_ms=5.0)
    scaler = serving.ServingAutoscaler(d, spec, service="auto",
                                       max_replicas=3, shed_rate_up=0.01,
                                       server_kwargs=kw)
    scaler.adopt(serving.InferenceServer(d, registry=spec,
                                         service="auto", **kw))
    cli = serving.ServingClient(registry=spec, service="auto",
                                rediscover_ttl_s=0.2)
    stop = threading.Event()

    def load():
        while not stop.is_set():
            try:
                cli.embed(ids[:64])  # sheds retried inside the client
            except serving.ServerOverloaded:
                pass

    threads = [threading.Thread(target=load, daemon=True) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        actions = []
        deadline = time.monotonic() + JOIN_S
        while scaler.replica_count() < 3 and time.monotonic() < deadline:
            stop.wait(0.3)
            a = scaler.step()
            if a:
                actions.append(a)
        stop.set()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert scaler.replica_count() == 3 and actions == ["up", "up"]
        assert len(wire.discover_replicas(spec, "auto")) == 3
        scaler.observe()  # close the loaded window
        scaler.calm_windows_down = 1
        assert scaler.step() == "down"
        assert scaler.replica_count() == 2
        assert len(wire.discover_replicas(spec, "auto")) == 2
        np.testing.assert_array_equal(cli.embed(ids[:8]), emb[:8])
    finally:
        stop.set()
        cli.close()
        scaler.close()
