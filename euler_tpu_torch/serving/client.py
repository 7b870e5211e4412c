"""ServingClient: retrying, failover-capable, SHARD-AWARE client for a
fleet of InferenceServer replicas (copy of euler_tpu/serving/client.py
over the port's wire, retry and obs modules; the port imports nothing
of euler_tpu). It speaks to either package's servers: the wire is the
same, byte for byte.

Reuses the graph client's resilience vocabulary wholesale: RetryPolicy
(exponential backoff, full jitter, per-call deadline, per-attempt
timeout) and the transport-vs-semantic error split of
`retryable_error`. Replicas come from a static ``hosts:h:p,h:p`` list
(treated as one shard) or are discovered live from the registry as a
FLEET — ``{shard -> [replicas]}`` parsed off the same namespace the
graph shards heartbeat into. A transport failure rotates replicas
WITHIN the failed shard and, under a registry, re-resolves the fleet —
a killed-and-restarted replica rejoins traffic within its heartbeat
interval, exactly like a graph shard does for trainers. Re-resolution
also DROPS cached connections to endpoints that left the replica set,
so a departed replica's socket never lingers until its next transport
error.

Scatter-gather (the multi-shard paths, thread-pool fan-out in the
style of the pipelined graph client):

  knn    two-phase: resolve each query id's embedding at its OWNING
         shard (an exact gather — a shard must never mistake another
         shard's id for an unknown), then broadcast the query VECTORS
         to every shard concurrently and merge per-shard top-k into
         the global top-k. Stable sorts end to end (each shard's
         brute force, then the merge over candidates concatenated in
         shard order) resolve ties in global row order, so the merged
         exact result is byte-identical to a single-index
         tools/knn.brute_force over the whole corpus — zero-vector
         unknown-id queries included.
  embed  scattered to owning shards by id range (binary search over
         shard lower bounds fetched once per fleet generation from
         info()), reassembled in request order. Byte-identical to the
         monolith (it is the same gather).
  score  same-shard pairs go to their shard's score verb; cross-shard
         pairs are resolved as two embed gathers + a client-side dot
         (float32 — summation order differs from the on-replica device
         reduce, so cross-shard scores match to fp tolerance, not
         bitwise).

An explicit SHED reply from an overloaded replica is retried on
another replica of the same shard under the same deadline; when the
deadline runs out the LAST explicit status is raised —
ServerOverloaded for sheds, RetryDeadlineExceeded for transport — so
no request ever ends without a status, and a fan-out raises the
failing shard's status rather than inventing a partial answer.

`swap_fleet(bundle_dir)` performs the rolling zero-downtime promotion:
every live replica, one at a time, loads vN+1 beside vN, warms, and
flips — traffic keeps flowing on the replicas not currently warming.
"""

from __future__ import annotations

import itertools
import json
import random
import select
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.estimator.retry import (
    EngineError,
    RetryDeadlineExceeded,
    RetryPolicy,
    retryable_error,
)
from euler_tpu_torch.serving import wire

__all__ = ["ServingClient", "ServerOverloaded"]

_CLIENT_IDS = itertools.count()


class ServerOverloaded(EngineError):
    """Every attempted replica answered SHED for the whole deadline —
    the overload was explicit end to end."""


class ServingClient:
    """Client for a serving service (see module docstring).

    endpoints: "hosts:h:p,h:p" static replica list (single shard), OR
      None with `registry` set — a registry spec ("tcp:host:port" /
      "dir:/path") plus `service` to discover the fleet from.
    retry_policy: backoff/deadline/per-attempt-timeout; the default is
      a 10s deadline with a 5s per-attempt socket timeout.
    stale_ms: registry entries older than this are skipped (a crashed
      replica that never deregistered).
    fanout: max concurrent shard calls per scatter-gather (0 = one
      worker per shard).
    swap_timeout_s: per-replica bound on a hot-swap admin call (the
      replica loads, uploads and warms a bundle inside it).
    """

    def __init__(self, endpoints: Optional[str] = None,
                 registry: Optional[str] = None, service: str = "default",
                 retry_policy: Optional[RetryPolicy] = None,
                 stale_ms: int = 10_000, seed: int = 0,
                 fanout: int = 0, swap_timeout_s: float = 120.0,
                 bounds_ttl_s: float = 30.0, hedge: bool = False,
                 hedge_quantile: float = 0.9, hedge_min_ms: float = 1.0,
                 hedge_max_ms: float = 200.0, p2c: bool = False,
                 rediscover_ttl_s: float = 0.0):
        """Tail-latency knobs (both opt-in, both byte-identical on the
        wire when off):

        hedge: adaptive straggler hedging per scatter-gather leg — a
          sub-call whose reply exceeds the hedge delay fires the SAME
          request on a SECOND replica of the same shard; the first
          reply wins and the loser is abandoned (its connection
          dropped so the stale reply can never be read into a later
          request). The delay adapts per shard: the hedge_quantile of
          the observed per-attempt latency histogram, clamped to
          [hedge_min_ms, hedge_max_ms] (max is also the cold-start
          delay). Counted hedge_fired / hedge_won / hedge_wasted.
        p2c: power-of-two-choices replica selection off the observed
          per-endpoint latency EWMA instead of blind rotation — two
          random replicas, take the historically faster one (unknown
          endpoints score as idle, so fresh replicas get explored).
        rediscover_ttl_s: > 0 re-resolves the registry at most every
          this-many seconds on the call path even when nothing failed —
          the elastic-fleet knob: replicas the AUTOSCALER just started
          begin receiving traffic within one TTL instead of only after
          a failure. 0 (default) keeps failure-driven re-resolution."""
        if not endpoints and not registry:
            raise ValueError("pass endpoints='hosts:h:p,...' or a "
                             "registry spec + service")
        self.service = service
        self.registry = registry
        self.stale_ms = int(stale_ms)
        self.fanout = int(fanout)
        self.swap_timeout_s = float(swap_timeout_s)
        self.bounds_ttl_s = float(bounds_ttl_s)
        self.rediscover_ttl_s = float(rediscover_ttl_s)
        self._next_rediscover = (time.monotonic() + self.rediscover_ttl_s
                                 if self.rediscover_ttl_s > 0 else None)
        self.retry = retry_policy or RetryPolicy(
            deadline_s=10.0, call_timeout_s=5.0)
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_max_ms = float(hedge_max_ms)
        self.p2c = bool(p2c)
        self._ep_lat: Dict[Tuple[str, int], float] = {}  # EWMA ms, _mu
        self._backoff_rng = random.Random(seed ^ 0x5E21 if seed else None)
        self._pick_rng = random.Random(seed ^ 0x9C2 if seed else None)
        self._static: Optional[List[Tuple[str, int]]] = None
        if endpoints:
            if not endpoints.startswith("hosts:"):
                raise ValueError("endpoints must be 'hosts:h:p,h:p'")
            self._static = []
            for part in endpoints[len("hosts:"):].split(","):
                host, _, port = part.strip().rpartition(":")
                self._static.append((host, int(port)))
        self._mu = threading.Lock()
        self._fleet: Dict[int, List[Tuple[str, int]]] = (
            {0: list(self._static)} if self._static else {})
        self._replicas: List[Tuple[str, int]] = list(self._static or [])
        self._rr: Dict[Optional[int], int] = {}
        # (generation, live endpoint set): bumped whenever re-resolution
        # changes the replica set; per-thread conn caches compare their
        # generation against this and drop sockets to departed endpoints
        self._live_state: Tuple[int, frozenset] = (
            0, frozenset(self._replicas))
        self._bounds: Optional[Tuple[List[int], np.ndarray]] = None
        self._bounds_gen = -1
        self._bounds_at = 0.0
        self._num_shards: Optional[int] = None  # fleet width, pinned
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._local = threading.local()  # per-thread connection cache
        self._obs_name = f"serving_client{next(_CLIENT_IDS)}"
        reg = _obs.default_registry()
        lab = {"client": self._obs_name}
        self._ctr = {
            k: reg.counter(f"serving_client_{k}_total", h,
                           ("client",)).labels(**lab)
            for k, h in (
                ("calls", "serving calls issued"),
                ("retries", "retry cycles (transport or shed)"),
                ("failovers", "calls that succeeded after >=1 failure"),
                ("sheds", "explicit SHED replies received"),
                ("deadline_exhausted", "calls that ran out of budget"),
                ("rediscoveries", "registry re-resolutions"),
                ("stale_conns_dropped",
                 "cached connections dropped because their endpoint "
                 "left the replica set"),
                ("swaps", "per-replica hot-swap admin calls issued"),
                ("hedge_fired", "hedge legs fired at straggling "
                                "sub-calls"),
                ("hedge_won", "hedged sub-calls won by the hedge leg"),
                ("hedge_wasted", "losing hedge legs abandoned after "
                                 "the other leg won"),
                ("p2c_picks", "replica selections decided by "
                              "power-of-two-choices"),
            )}
        self._ctr_fanout = {
            k: reg.counter(f"serving_fanout_{k}_total", h,
                           ("client",)).labels(**lab)
            for k, h in (
                ("queries", "logical queries scatter-gathered across "
                            "shards"),
                ("shard_calls", "per-shard sub-calls issued by "
                                "scatter-gather"),
                ("merges", "top-k merges performed"),
            )}
        self._hist_call_ms = reg.histogram(
            "serving_client_call_ms",
            "end-to-end serving call latency incl. retries",
            ("client",)).labels(**lab)
        self._hist_shard_ms = reg.histogram(
            "serving_client_shard_call_ms",
            "per-shard sub-call latency incl. retries",
            ("client", "shard"))
        # per-ATTEMPT wire latency (no backoff, no retries): the source
        # the adaptive hedge delay and p2c read their percentiles from
        self._hist_attempt_ms = reg.histogram(
            "serving_client_attempt_ms",
            "single-attempt wire latency per shard (hedge/p2c signal)",
            ("client", "shard"))
        self._last_error: Optional[str] = None
        _obs.register_health(self._obs_name, self.health)
        if self._static is None:
            self._rediscover(initial=True)

    # -- discovery ---------------------------------------------------------
    def _set_fleet(self, fleet: Dict[int, List[Tuple[str, int]]]) -> None:
        flat = [ep for s in sorted(fleet) for ep in fleet[s]]
        with self._mu:
            self._fleet = fleet
            self._replicas = flat
            gen, live = self._live_state
            new_live = frozenset(flat)
            if new_live != live:
                self._live_state = (gen + 1, new_live)

    def _rediscover(self, initial: bool = False) -> None:
        if self._static is not None:
            return
        try:
            found = wire.discover_fleet(self.registry, self.service,
                                        max_age_ms=self.stale_ms)
        except (OSError, wire.WireError) as e:
            if initial:
                raise
            with self._mu:
                self._last_error = f"registry scan: {e}"
            return
        self._ctr["rediscoveries"].inc()
        self._set_fleet(
            {s: [(h, p) for h, p, _ in eps] for s, eps in found.items()})

    def replicas(self) -> List[Tuple[str, int]]:
        with self._mu:
            return list(self._replicas)

    def shards(self) -> List[int]:
        with self._mu:
            return sorted(self._fleet)

    def _fleet_view(self) -> List[int]:
        """Registered shard list, validated against the fleet's declared
        width (num_shards from info(), fetched once per client — a swap
        can never change it, the server enforces shard identity). A
        shard whose every replica aged out of the registry must surface
        as an EXPLICIT error: quietly fanning out to the survivors would
        merge a partial top-k / zero-fill embeds of ids the fleet does
        hold — confidently wrong results with STATUS_OK."""
        shard_list = self.shards()
        if not shard_list:
            # never fall through to the single-shard path on an empty
            # scan: once re-resolution repopulates the fleet mid-call,
            # a shard=None retry would send the WHOLE query to one
            # arbitrary shard's replica — wrong results, STATUS_OK
            self._rediscover()
            shard_list = self.shards()
            if not shard_list:
                raise wire.WireError(
                    f"no live replicas for service {self.service!r} "
                    "(registry empty or all entries stale)")
        width = self._num_shards
        if width is None and shard_list:
            info = self._call(
                wire.MSG_INFO, lambda _r: b"",
                lambda r: json.loads(r.str_()),
                shard=shard_list[0], count=False)
            width = int(info.get("num_shards", 1))
            with self._mu:
                self._num_shards = width
        if width is not None and len(shard_list) < width:
            self._rediscover()
            shard_list = self.shards()
            if len(shard_list) < width:
                raise wire.WireError(
                    f"fleet incomplete: shards {shard_list} of "
                    f"{width} registered for service "
                    f"{self.service!r} — refusing a partial "
                    "scatter-gather")
        return shard_list

    def _next_replica(self, shard: Optional[int] = None,
                      avoid: Optional[Tuple[str, int]] = None
                      ) -> Tuple[str, int]:
        """Pick a replica (within `shard` when given): power-of-two-
        choices off the per-endpoint latency EWMA when p2c is on, blind
        rotation otherwise. `avoid` excludes one endpoint — the hedge
        leg must land on a DIFFERENT replica than its primary."""
        with self._mu:
            pool = self._replicas if shard is None \
                else self._fleet.get(shard, [])
            if avoid is not None:
                pool = [ep for ep in pool if ep != avoid]
                if pool:
                    # hedge-leg pick: the historically fastest OTHER
                    # replica, WITHOUT advancing the rotation counter —
                    # a hedge consuming rotation slots would lock the
                    # primary rotation's parity onto one replica
                    return min(pool,
                               key=lambda e: self._ep_lat.get(e, 0.0))
            if not pool:
                # WireError subclasses ConnectionError → the call loop
                # treats an (often transient) empty replica set as
                # retryable and keeps re-resolving until the deadline
                where = f"shard {shard} of " if shard is not None else ""
                raise wire.WireError(
                    f"no live replicas for {where}service "
                    f"{self.service!r} (registry empty or all entries "
                    "stale)")
            if self.p2c and len(pool) >= 2:
                a, b = self._pick_rng.sample(range(len(pool)), 2)
                # unknown endpoints score 0.0 (idle): a fresh replica
                # gets explored instead of starved behind history
                la = self._ep_lat.get(pool[a], 0.0)
                lb = self._ep_lat.get(pool[b], 0.0)
                self._ctr["p2c_picks"].inc()
                return pool[a] if la <= lb else pool[b]
            i = self._rr.get(shard, 0)
            self._rr[shard] = i + 1
            return pool[i % len(pool)]

    def _observe_attempt(self, ep: Tuple[str, int],
                         shard: Optional[int], ms: float) -> None:
        """Per-attempt latency bookkeeping: the per-shard histogram the
        adaptive hedge delay reads, and the per-endpoint EWMA p2c
        ranks replicas by."""
        if shard is not None:
            self._hist_attempt_ms.labels(
                client=self._obs_name, shard=str(shard)).observe(ms)
        with self._mu:
            old = self._ep_lat.get(ep)
            self._ep_lat[ep] = ms if old is None \
                else 0.7 * old + 0.3 * ms

    def _hedge_delay_s(self, shard: int) -> float:
        """Adaptive hedge trigger: the hedge_quantile of this shard's
        observed per-attempt latency, clamped to [hedge_min_ms,
        hedge_max_ms]; the max is also the cold-start delay before any
        observations exist."""
        q = self._hist_attempt_ms.labels(
            client=self._obs_name, shard=str(shard)).quantile(
            self.hedge_quantile)
        ms = self.hedge_max_ms if q is None else min(
            max(float(q), self.hedge_min_ms), self.hedge_max_ms)
        return ms / 1000.0

    def _abandon(self, ep: Tuple[str, int], wasted: bool = True) -> None:
        """Abandon a hedge leg: its connection carries an unread reply
        that would poison the NEXT request on a cached socket, so the
        conn is dropped (closed), the reply discarded unread — it never
        reaches a decoder, so it cannot mutate anything. wasted=True
        counts the leg (exactly the abandoned-after-a-winner legs)."""
        self._drop_conn(ep)
        if wasted:
            self._ctr["hedge_wasted"].inc()

    def _exchange_hedged(self, s: socket.socket, ep: Tuple[str, int],
                         shard: int, msg_type: int, body: bytes,
                         deadline: float):
        """One request/reply exchange with adaptive hedging: write on
        the primary; if no reply lands inside the hedge delay, fire the
        SAME request at a second replica and take the first readable
        reply — the loser is abandoned (connection dropped, reply
        discarded unread). Returns (reply_type, reply, winner_ep).

        Latency attribution is per LEG: the winner records its own
        write→reply time, and an abandoned leg records its elapsed
        time at abandonment — a truthful lower bound that keeps a
        straggler ranked slow in the p2c EWMA and keeps the straggle
        visible to the adaptive-delay histogram (observing winners
        only would shrink the quantile toward hedge_min and over-fire
        hedges)."""
        t0 = time.monotonic()
        wire.write_frame(s, msg_type, body)
        remaining = deadline - t0
        delay = min(self._hedge_delay_s(shard), max(remaining, 0.001))
        readable, _, _ = select.select([s], [], [], max(delay, 0.0))
        if readable:
            rt, rb = wire.read_frame(s)
            self._observe_attempt(ep, shard,
                                  (time.monotonic() - t0) * 1000.0)
            return rt, rb, ep
        try:
            ep2 = self._next_replica(shard, avoid=ep)
        except wire.WireError:
            ep2 = None  # single-replica shard: nothing to hedge to
        s2 = None
        if ep2 is not None:
            try:
                s2 = self._conn(ep2)
                t1 = time.monotonic()
                wire.write_frame(s2, msg_type, body)
                self._ctr["hedge_fired"].inc()
            except (OSError, wire.WireError):
                # the hedge replica is unreachable: fall back to the
                # primary leg alone (a failed hedge must not fail a
                # call its primary could still win)
                self._drop_conn(ep2)
                s2 = None
        if s2 is None:
            rt, rb = wire.read_frame(s)
            self._observe_attempt(ep, shard,
                                  (time.monotonic() - t0) * 1000.0)
            return rt, rb, ep
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # no winner inside the budget: both legs are failures
                # (not wasted hedges); both conns carry straggling
                # replies and must go
                self._abandon(ep, wasted=False)
                self._abandon(ep2, wasted=False)
                raise socket.timeout(
                    "hedged call: no leg answered inside the deadline")
            readable, _, _ = select.select([s, s2], [], [], remaining)
            if not readable:
                continue
            winner_is_primary = readable[0] is s
            try:
                rt, rb = wire.read_frame(s if winner_is_primary else s2)
            except (OSError, wire.WireError):
                # the winning socket died mid-frame: abandon both legs
                # (the other carries an unread reply) and let the retry
                # machinery classify the failure
                self._abandon(ep, wasted=False)
                self._abandon(ep2, wasted=False)
                raise
            now = time.monotonic()
            if winner_is_primary:
                # the hedge leg lost a SHORT race — its elapsed says
                # nothing about the replica's speed, so it records no
                # sample (an optimistic tiny value would flatter it)
                self._observe_attempt(ep, shard, (now - t0) * 1000.0)
                self._abandon(ep2)
                return rt, rb, ep
            self._ctr["hedge_won"].inc()
            self._observe_attempt(ep2, shard, (now - t1) * 1000.0)
            # the abandoned primary was outrun by delay+race: its
            # elapsed is a truthful LOWER BOUND — recorded so the
            # straggle stays visible to the EWMA and the delay quantile
            self._observe_attempt(ep, shard, (now - t0) * 1000.0)
            self._abandon(ep)
            return rt, rb, ep2

    # -- connections (one cached socket per thread per endpoint) ----------
    def _conn(self, ep: Tuple[str, int]) -> socket.socket:
        st = self._local
        conns = getattr(st, "conns", None)
        if conns is None:
            conns = st.conns = {}
        gen, live = self._live_state
        if getattr(st, "gen", -1) != gen:
            # the replica set changed since this thread last looked:
            # drop sockets to departed endpoints NOW instead of keeping
            # them around until their next transport error
            for dead in [e for e in conns if e not in live]:
                s = conns.pop(dead)
                self._ctr["stale_conns_dropped"].inc()
                try:
                    s.close()
                except OSError:
                    pass
            st.gen = gen
        s = conns.get(ep)
        if s is None:
            timeout = self.retry.call_timeout_s or 5.0
            s = socket.create_connection(ep, timeout=timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conns[ep] = s
        return s

    def _drop_conn(self, ep: Tuple[str, int]) -> None:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            return
        s = conns.pop(ep, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    # -- core call loop ----------------------------------------------------
    def _call(self, msg_type: int, make_body, decode,
              shard: Optional[int] = None, count: bool = True):
        """One logical call under RetryPolicy: transport failures and
        SHED replies rotate replicas (within `shard` when given) with
        backoff until the deadline; semantic ERROR replies raise
        immediately. count=False keeps client-internal probes (the
        one-time fleet-width info fetch) out of the calls counter, so
        calls == user requests stays an exact accounting identity."""
        pol = self.retry
        if count:
            self._ctr["calls"].inc()
        if self._next_rediscover is not None \
                and time.monotonic() >= self._next_rediscover:
            # TTL re-resolution (elastic fleet): autoscaled-up replicas
            # join the rotation within one TTL, not only after failures
            self._next_rediscover = (time.monotonic()
                                     + self.rediscover_ttl_s)
            self._rediscover()
        deadline = time.monotonic() + max(pol.deadline_s, 0.0)
        attempt = 0
        last_shed: Optional[str] = None
        t_start = time.monotonic()
        try:
            while True:
                remaining = deadline - time.monotonic()
                ep = None
                try:
                    ep = self._next_replica(shard)
                    s = self._conn(ep)
                    body = make_body(max(remaining, 0.001))
                    if self.hedge and shard is not None:
                        # per-LEG latency attribution happens inside:
                        # charging the whole exchange (primary straggle
                        # + hedge delay) to the winner would rank the
                        # rescuing replica as the slow one
                        reply_type, reply, ep = self._exchange_hedged(
                            s, ep, shard, msg_type, body, deadline)
                    else:
                        t_att = time.monotonic()
                        wire.write_frame(s, msg_type, body)
                        reply_type, reply = wire.read_frame(s)
                        self._observe_attempt(
                            ep, shard,
                            (time.monotonic() - t_att) * 1000.0)
                    if reply_type != msg_type:
                        raise wire.WireError(
                            f"reply type {reply_type} != {msg_type}")
                    r = wire.Reader(reply)
                    status = r.u32()
                    if status == wire.STATUS_OK:
                        if attempt:
                            self._ctr["failovers"].inc()
                        return decode(r)
                    reason = r.str_()
                    if status == wire.STATUS_SHED:
                        self._ctr["sheds"].inc()
                        last_shed = reason
                        raise ServerOverloaded(f"{ep[0]}:{ep[1]} shed: "
                                               f"{reason}")
                    raise EngineError(
                        f"serving error from {ep[0]}:{ep[1]}: {reason}")
                except (ServerOverloaded, ConnectionError, OSError,
                        socket.timeout, EngineError) as e:
                    transient = isinstance(
                        e, (ServerOverloaded, ConnectionError, OSError,
                            socket.timeout)) or retryable_error(e)
                    if ep is not None and not isinstance(e,
                                                         ServerOverloaded):
                        self._drop_conn(ep)
                    if not transient:
                        raise
                    attempt += 1
                    with self._mu:
                        self._last_error = str(e)
                    now = time.monotonic()
                    exhausted = (now >= deadline
                                 or (pol.max_attempts
                                     and attempt >= pol.max_attempts))
                    if exhausted:
                        self._ctr["deadline_exhausted"].inc()
                        if last_shed is not None and isinstance(
                                e, ServerOverloaded):
                            raise ServerOverloaded(
                                f"serving gave up after {attempt} "
                                f"attempt(s): shed ({last_shed})") from e
                        raise RetryDeadlineExceeded(
                            f"serving call gave up after {attempt} "
                            f"attempt(s) ({pol.deadline_s:.1f}s "
                            f"deadline): {e}") from e
                    self._ctr["retries"].inc()
                    self._rediscover()
                    sleep = min(pol.backoff_s(attempt, self._backoff_rng),
                                max(deadline - now, 0.0))
                    time.sleep(sleep)
        finally:
            dt_ms = (time.monotonic() - t_start) * 1000.0
            self._hist_call_ms.observe(dt_ms)
            if shard is not None:
                self._hist_shard_ms.labels(
                    client=self._obs_name, shard=str(shard)).observe(dt_ms)

    @staticmethod
    def _deadline_ms(remaining_s: float) -> int:
        return int(min(max(remaining_s, 0.001) * 1000.0, 0xFFFFFFFF))

    # -- fan-out machinery -------------------------------------------------
    def _submit_all(self, jobs: List) -> List:
        """Grow-if-needed the fan-out pool and submit every job under
        ONE lock hold: a concurrent grower replaces (and shuts down)
        the pool, so fetch-then-submit as two steps could submit on a
        just-shut-down executor and raise RuntimeError outside the
        retry machinery. Submission is enqueue-only — cheap to hold
        the lock across."""
        with self._mu:
            want = max(len(jobs), 2)
            if self.fanout > 0:
                want = min(want, self.fanout)
            if self._pool is None or self._pool_size < want:
                old = self._pool
                self._pool = ThreadPoolExecutor(
                    max_workers=want,
                    thread_name_prefix=f"{self._obs_name}-fanout")
                self._pool_size = want
                if old is not None:
                    old.shutdown(wait=False)
            return [self._pool.submit(j) for j in jobs]

    def _fanout(self, jobs: List) -> List:
        """Run thunks concurrently on the fan-out pool; re-raise the
        first failure (a shard that ran out its whole retry deadline
        surfaces ITS explicit status — never a silent partial merge).
        A fan-out issued FROM a fan-out worker runs inline instead:
        parents parked on a pool slot waiting for children that need a
        pool slot is a deadlock, not parallelism."""
        self._ctr_fanout["shard_calls"].inc(len(jobs))
        if len(jobs) == 1 or threading.current_thread().name.startswith(
                f"{self._obs_name}-fanout"):
            return [j() for j in jobs]
        return [f.result() for f in self._submit_all(jobs)]

    def _shard_bounds(self) -> Tuple[List[int], np.ndarray]:
        """(shard ids, uint64 lower id bound per shard) for id-range
        routing, fetched from each shard's info() and cached per fleet
        generation with a bounds_ttl_s expiry. The TTL matters beyond
        freshness: a hot-swap that shifts shard boundaries does NOT
        change the endpoint set, so generation alone would leave every
        client that didn't issue the swap routing on stale bounds
        forever — the TTL bounds that window."""
        gen = self._live_state[0]
        with self._mu:
            if (self._bounds is not None and self._bounds_gen == gen
                    and (time.monotonic() - self._bounds_at)
                    < self.bounds_ttl_s):
                return self._bounds
        shard_ids = self.shards()
        infos = self._fanout([
            (lambda s=s: (s, self._call(
                wire.MSG_INFO, lambda _r: b"",
                lambda r: json.loads(r.str_()), shard=s, count=False)))
            for s in shard_ids])
        los = []
        for s, info in infos:
            lo = info.get("id_lo")
            # an empty shard owns no ids: push its bound past every
            # possible id so routing never lands on it
            los.append(int(lo) if lo is not None else (1 << 64) - 1)
        bounds = (shard_ids, np.asarray(los, dtype=np.uint64))
        with self._mu:
            self._bounds = bounds
            self._bounds_gen = gen
            self._bounds_at = time.monotonic()
        return bounds

    def _owners(self, ids: np.ndarray) -> Tuple[List[int], np.ndarray]:
        """(shard ids, owning-shard POSITION per query id). Ids below
        the first bound clip to shard 0; ids in nobody's range route to
        the range they fall in and come back as zeros — the same
        unknown-id semantics the monolith has."""
        shard_ids, los = self._shard_bounds()
        pos = np.searchsorted(los, ids.astype(np.uint64),
                              side="right").astype(np.int64) - 1
        return shard_ids, np.clip(pos, 0, len(shard_ids) - 1)

    # -- verbs -------------------------------------------------------------
    def embed(self, ids) -> np.ndarray:
        """[n, D] float32 embedding rows (zeros for unknown ids).
        Multi-shard fleets scatter by owning id range and reassemble —
        byte-identical to the monolith gather."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        shard_list = self._fleet_view()
        if len(shard_list) > 1 and ids.size:
            self._ctr_fanout["queries"].inc()
        return self._embed_ids(ids, shard_list)

    def _embed_ids(self, ids: np.ndarray,
                   shard_list: List[int]) -> np.ndarray:
        """embed() body without the logical-query counter: knn phase 1
        and cross-shard score ride through here so ONE logical query
        counts once, however many internal gathers it needs."""
        if len(shard_list) <= 1 or ids.size == 0:
            return self._embed_one(
                ids, shard_list[0] if shard_list else None)
        shard_ids, pos = self._owners(ids)
        groups = [(shard_ids[p], np.nonzero(pos == p)[0])
                  for p in np.unique(pos)]
        parts = self._fanout([
            (lambda s=s, idx=idx: (idx, self._embed_one(ids[idx], s)))
            for s, idx in groups])
        dim = parts[0][1].shape[1] if parts else 0
        out = np.zeros((ids.size, dim), np.float32)
        for idx, rows in parts:
            out[idx] = rows
        return out

    def _embed_one(self, ids: np.ndarray,
                   shard: Optional[int]) -> np.ndarray:
        def body(remaining):
            return struct.pack("<II", self._deadline_ms(remaining),
                               ids.size) + ids.tobytes()

        def decode(r: wire.Reader):
            n = r.u32()
            dim = r.u32()
            return r.array(np.float32, n * dim).reshape(n, dim)

        return self._call(wire.MSG_EMBED, body, decode, shard=shard)

    def knn(self, ids, k: int = 10,
            exact: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query top-k: (neighbor ids [n, k] uint64, inner-product
        scores [n, k] float32). On a multi-shard fleet this is the
        scatter-gather: query vectors resolved at their owning shard,
        broadcast to every shard concurrently, per-shard top-k stable-
        merged into the global top-k — with exact=True the result is
        byte-identical to a single-index tools/knn.brute_force over the
        whole corpus (see module docstring). exact=False routes through
        each shard's IVFFlat index (approximate, faster at corpus
        scale; the merge is the same but carries no bitwise guarantee).
        The returned k may be clipped to the corpus size."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        shard_list = self._fleet_view()
        if len(shard_list) <= 1:
            return self._knn_ids(
                ids, k, exact, shard_list[0] if shard_list else None)
        # phase 1: exact query vectors from the owning shards
        vecs = self._embed_ids(ids, shard_list)
        # phase 2: broadcast vectors, gather per-shard top-k
        self._ctr_fanout["queries"].inc()
        parts = self._fanout([
            (lambda s=s: self._knn_vec(vecs, k, exact, s))
            for s in shard_list])
        return self._merge_topk(parts, k)

    def _knn_ids(self, ids: np.ndarray, k: int, exact: bool,
                 shard: Optional[int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        def body(remaining):
            return struct.pack(
                "<IIBI", self._deadline_ms(remaining), int(k),
                1 if exact else 0, ids.size) + ids.tobytes()

        return self._call(wire.MSG_KNN, body, self._decode_topk,
                          shard=shard)

    def _knn_vec(self, vecs: np.ndarray, k: int, exact: bool,
                 shard: int) -> Tuple[np.ndarray, np.ndarray]:
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)

        def body(remaining):
            return struct.pack(
                "<IIBII", self._deadline_ms(remaining), int(k),
                1 if exact else 0, vecs.shape[0], vecs.shape[1]) \
                + vecs.tobytes()

        return self._call(wire.MSG_KNN_VEC, body, self._decode_topk,
                          shard=shard)

    @staticmethod
    def _decode_topk(r: wire.Reader):
        n = r.u32()
        got_k = r.u32()
        nbr = r.array(np.uint64, n * got_k).reshape(n, got_k)
        sims = r.array(np.float32, n * got_k).reshape(n, got_k)
        return nbr, sims

    def _merge_topk(self, parts, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Merge per-shard top-k into the global top-k. Candidates are
        concatenated in SHARD ORDER (= ascending global row order for
        contiguous shards) and selected with a STABLE sort on -sims, so
        ties resolve toward the lower global row — exactly the total
        order the stable single-index brute force uses. Byte-identical
        by construction (per-shard sims are bitwise slices of the full
        GEMM: the reduction runs over the same D either way)."""
        self._ctr_fanout["merges"].inc()
        nbr = np.concatenate([p[0] for p in parts], axis=1)
        sims = np.concatenate([p[1] for p in parts], axis=1)
        kk = min(int(k), nbr.shape[1])
        order = np.argsort(-sims, axis=1, kind="stable")[:, :kk]
        return (np.take_along_axis(nbr, order, axis=1),
                np.take_along_axis(sims, order, axis=1))

    def score(self, src, dst) -> np.ndarray:
        """Inner product per (src, dst) pair: [n] float32 (0.0 when
        either end is unknown). Same-shard pairs are scored on their
        replica; cross-shard pairs resolve both embeddings and dot on
        the client (fp tolerance vs the monolith, see module
        docstring)."""
        src = np.ascontiguousarray(src, dtype=np.uint64).ravel()
        dst = np.ascontiguousarray(dst, dtype=np.uint64).ravel()
        if src.size != dst.size:
            raise ValueError(f"src has {src.size} ids, dst {dst.size}")
        shard_list = self._fleet_view()
        if len(shard_list) <= 1 or src.size == 0:
            return self._score_one(
                src, dst, shard_list[0] if shard_list else None)
        shard_ids, spos = self._owners(src)
        _, dpos = self._owners(dst)
        same = spos == dpos
        out = np.zeros(src.size, np.float32)
        self._ctr_fanout["queries"].inc()
        # cross-shard pairs first (embed() fans out internally); then
        # the same-shard groups in one concurrent wave
        cross = np.nonzero(~same)[0]
        if cross.size:
            # one deduplicated embed over BOTH ends: two sequential
            # embed() calls would pay two full fan-out waves
            uniq, inv = np.unique(
                np.concatenate([src[cross], dst[cross]]),
                return_inverse=True)
            emb_u = self._embed_ids(uniq, shard_list)
            out[cross] = np.einsum(
                "ij,ij->i", emb_u[inv[:cross.size]],
                emb_u[inv[cross.size:]]).astype(np.float32)
        jobs = []
        for p in np.unique(spos[same]):
            idx = np.nonzero(same & (spos == p))[0]
            jobs.append((lambda s=shard_ids[p], idx=idx:
                         (idx, self._score_one(src[idx], dst[idx], s))))
        if jobs:
            for idx, vals in self._fanout(jobs):
                out[idx] = vals
        return out

    def _score_one(self, src: np.ndarray, dst: np.ndarray,
                   shard: Optional[int]) -> np.ndarray:
        def body(remaining):
            return struct.pack("<II", self._deadline_ms(remaining),
                               src.size) + src.tobytes() + dst.tobytes()

        def decode(r: wire.Reader):
            n = r.u32()
            return r.array(np.float32, n)

        return self._call(wire.MSG_SCORE, body, decode, shard=shard)

    def server_health(self, shard: Optional[int] = None) -> Dict:
        """One replica's health() dict (round-robin pick, optionally
        pinned to a shard)."""
        return self._call(wire.MSG_HEALTH, lambda _r: b"",
                          lambda r: json.loads(r.str_()), shard=shard)

    def info(self, shard: Optional[int] = None) -> Dict:
        """Service/bundle identity of one replica (dim, count, shard,
        bundle_version, id range)."""
        return self._call(wire.MSG_INFO, lambda _r: b"",
                          lambda r: json.loads(r.str_()), shard=shard)

    def fleet_info(self) -> Dict[int, Dict]:
        """{shard -> info()} across the fleet (concurrent)."""
        shard_list = self.shards()
        return dict(self._fanout([
            (lambda s=s: (s, self.info(shard=s))) for s in shard_list]))

    # -- zero-downtime promotion -------------------------------------------
    def swap_fleet(self, bundle_dir: str) -> Dict[str, Dict]:
        """Rolling zero-downtime promotion: tell EVERY live replica,
        one at a time, to load `bundle_dir` beside its serving bundle,
        warm it, and flip (wire MSG_SWAP). Sequential on purpose — the
        fleet keeps serving on the replicas not currently warming.
        Returns {"host:port": swap reply}. Raises on the first replica
        that fails, leaving the fleet mixed-version; re-running
        converges (an already-promoted replica just swaps to the same
        version again)."""
        with self._mu:
            eps = list(self._replicas)
        if not eps:
            raise wire.WireError(
                f"no live replicas for service {self.service!r}")
        out: Dict[str, Dict] = {}
        for ep in eps:
            self._ctr["swaps"].inc()
            out[f"{ep[0]}:{ep[1]}"] = self._swap_one(ep, bundle_dir)
        # the promoted bundle may shard the id space differently (same
        # shard count, shifted contiguous boundaries): drop the cached
        # id-range routing table so the next routed call refetches it
        with self._mu:
            self._bounds = None
        return out

    def _swap_one(self, ep: Tuple[str, int], bundle_dir: str) -> Dict:
        """One replica's swap on a DEDICATED socket (load+warm can take
        far longer than the cached data-path sockets' timeout)."""
        body = wire.pack_str(bundle_dir)
        with socket.create_connection(
                ep, timeout=self.swap_timeout_s) as s:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            wire.write_frame(s, wire.MSG_SWAP, body)
            reply_type, reply = wire.read_frame(s)
            if reply_type != wire.MSG_SWAP:
                raise wire.WireError(
                    f"reply type {reply_type} != {wire.MSG_SWAP}")
            r = wire.Reader(reply)
            status = r.u32()
            if status != wire.STATUS_OK:
                raise EngineError(
                    f"swap failed on {ep[0]}:{ep[1]}: {r.str_()}")
            return json.loads(r.str_())

    # -- introspection / lifecycle -----------------------------------------
    def health(self) -> Dict:
        """Client-side counter view (obs registry children): calls,
        retries, failovers, sheds, deadline_exhausted, rediscoveries,
        stale-conn drops, swap calls, fan-out counters, last_error,
        live replica/shard counts."""
        out = {k: int(c.value) for k, c in self._ctr.items()}
        out["fanout"] = {k: int(c.value)
                        for k, c in self._ctr_fanout.items()}
        with self._mu:
            out["last_error"] = self._last_error
            out["replicas"] = len(self._replicas)
            out["shards"] = len(self._fleet)
        return out

    def close(self) -> None:
        _obs.unregister_health(self._obs_name)
        with self._mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        conns = getattr(self._local, "conns", None)
        if conns:
            for s in conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            conns.clear()

    def __enter__(self) -> "ServingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
