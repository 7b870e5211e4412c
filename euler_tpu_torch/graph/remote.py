"""Remote graph client: the GraphEngine batch API served by a shard
cluster over GQL (copy of euler_tpu/graph/remote.py over the port's
engine build; `retryable_error`, `RetryDeadlineExceeded` and
`RetryPolicy` are the copies in estimator/retry.py, re-exported here).

Parity: the reference's TF custom kernels build a GQL string per op and
run it through QueryProxy against remote shards (SURVEY.md §3.3,
tf_euler/kernels/sample_fanout_op.cc:36-48 — the chained
".sampleNB().as(nb_i)" one-round-trip fanout). Here the same idea backs
the GraphEngine surface the dataflows/estimators consume, so a trainer
switches from embedded to cluster mode by swapping the graph object:

    remote = RemoteGraphEngine("hosts:127.0.0.1:9190,127.0.0.1:9191")
    flow = FanoutDataFlow(remote, [10, 10], feature_ids=["feature"])
    est = NodeEstimator(model, params, remote, flow, ...)

Every sample_fanout call is ONE query (compile-cached server-side plan,
split/REMOTE/merge per shard) — the host-side feeding pattern the
reference's whole design exists to amortize. With pool_size > 0 the
engine additionally runs the pipelined client (graph/pipeline.py):
submit() futures, and large id sets fanned out as concurrent chunks
instead of one blocking query at a time.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.estimator.retry import (  # noqa: F401 (re-exported)
    EngineError,
    RetryDeadlineExceeded,
    RetryPolicy,
    retryable_error,
)
from euler_tpu_torch.gql import Query

# process-wide engine numbering: the per-instance label value on the
# shared graph_rpc_* metrics (euler_tpu_torch.obs), so N engines in one
# process report side by side and health() stays an exact per-engine
# view
_ENGINE_IDS = itertools.count()

# health() counter keys ↔ registry counters (one definition: the compat
# view iterates this, so view and bookkeeping cannot drift)
_RPC_COUNTERS = {
    "calls": "graph rpc calls issued (before any retry)",
    "retries": "retry sleep cycles taken on transport failures",
    "failovers": "calls that failed then succeeded on a retry",
    "degraded": "default_id-padded results served (degrade=True)",
    "deadline_exhausted": "calls that ran out of retry budget",
    "health_merge_errors": "proxy stats() failures during health()",
    # elastic fleet: a shard refused the call because it was routed on
    # a superseded ownership map — the engine refreshed the registry-
    # published map (rebuilding its proxies when the fleet grew) and
    # retried; never a silent misroute
    "stale_map_retries": "calls refused as stale-map, refreshed + retried",
    "ownership_refreshes": "ownership-map refreshes applied",
}

# ---------------------------------------------------------------------------
# RPC transport config (protocol v2 mux + adaptive frame compression)
# ---------------------------------------------------------------------------
# Native client-edge counter layout (etg_rpc_stats) — order must match
# capi.cc. *_raw is the pre-compression payload view of the same frames,
# so bytes_received_raw / bytes_received is the reply compression ratio.
_RPC_STAT_KEYS = (
    "round_trips", "bytes_sent", "bytes_received", "bytes_sent_raw",
    "bytes_received_raw", "connections_opened", "compressed_frames_sent",
    "compressed_frames_received", "mux_calls", "v1_calls",
    "hello_fallbacks", "inflight",
    # tail-latency machinery: deadline_shed is SERVER-edge (loopback
    # tests see both edges in one process), the rest client-edge
    "deadline_propagated", "deadline_shed", "hedge_fired", "hedge_won",
    "hedge_wasted",
    # elastic fleet: stale_map_shed is SERVER-edge (requests refused as
    # routed on a superseded ownership map); replica_hedge_* count
    # ClientManager's cross-replica races (hedge_replicas)
    "stale_map_shed", "replica_hedge_fired", "replica_hedge_won",
    "replica_hedge_wasted",
    # cross-process tracing: kExecute requests stamped with a wire
    # trace context (zero with tracing off / against pre-trace peers —
    # the wire-identity pins read exactly this)
    "trace_propagated",
    # prepared query plans (wire path): registered/hits/misses/
    # invalidated are SERVER-edge plan-cache accounting (a miss or an
    # ownership-flip invalidation is always an explicit status the
    # client answers by re-preparing); fallbacks is CLIENT-edge — a
    # prepared call that went out as a classic full-plan frame
    "prepared_registered", "prepared_hits", "prepared_misses",
    "prepared_invalidated", "prepared_fallbacks",
    # prepare-time plan optimizer + deterministic fast paths (all
    # SERVER-edge): plan_optimized counts registrations the optimizer
    # rewrote, plan_rewrites_* the per-pass rewrite totals
    # (fuse/pushdown/dedup; epoch = per-epoch distribute re-derivations
    # on a generation-bumped re-registration); coalesced_requests rode a
    # neighbor's identical execute, coalesce_batches answered > 1
    # request; reuse_hits/misses/invalidated account the bounded
    # deterministic result-reuse window (invalidated = entries purged on
    # a graph-epoch or ownership-map bump — staleness is structurally
    # impossible, every bump empties the window)
    "plan_optimized", "plan_rewrites_fuse", "plan_rewrites_pushdown",
    "plan_rewrites_dedup", "plan_rewrites_epoch", "coalesced_requests",
    "coalesce_batches", "reuse_hits", "reuse_misses", "reuse_invalidated")

# Last config applied through configure_rpc (the native side has no
# getter). RemoteGraphEngine reads `mux` to default pool_shared.
_RPC_CONFIG = {"mux": False, "connections": 1, "compress_threshold": 0,
               "max_inflight": 256, "hedge_delay_ms": 0.0, "p2c": False,
               "hedge_replicas": False, "prepared": False,
               "plan_cache": 64, "deflate_reuse": True,
               "plan_optimize": True, "coalesce_window_us": 0,
               "reuse_window": 0}
_rpc_mu = threading.Lock()
_rpc_env_applied = False
_rpc_obs_done = False


def configure_rpc(mux=None, connections=None, compress_threshold=None,
                  max_inflight=None, hedge_delay_ms=None,
                  p2c=None, hedge_replicas=None, prepared=None,
                  plan_cache=None, deflate_reuse=None, plan_optimize=None,
                  coalesce_window_us=None, reuse_window=None) -> dict:
    """Set the PROCESS-GLOBAL graph-RPC transport knobs; returns the
    resulting config. None leaves a knob unchanged. Applies to engines
    (native channels) built AFTER the call — except hedge_delay_ms and
    p2c, which live channels read per call.

    mux: one v2 connection carries many in-flight requests (correlation-
      id frames, demux reader) instead of one blocking fd per concurrent
      call; v1 servers are detected at the hello and served classic
      framing. connections: mux connections per shard endpoint.
    compress_threshold: > 0 zlib-1-deflates frame bodies >= this many
      bytes when the peer negotiated it (a frame that would not shrink
      is sent raw — adaptive per frame). max_inflight: per-connection
      in-flight cap (client blocks / server bounds dispatch past it).
    hedge_delay_ms: > 0 fires a HEDGE for a mux kExecute whose reply is
      this late — same request on a second mux connection, first reply
      wins, loser cancelled by request_id (hedge_fired/won/wasted
      counters). Needs connections >= 2. 0 disables (the byte-identical
      pre-hedging path). RemoteGraphEngine(hedge=True) keeps this
      ADAPTIVE off the observed latency histogram. p2c: power-of-two-
      choices mux connection selection off (inflight, EWMA latency)
      instead of blind rotation.
    hedge_replicas: additionally race a straggling kExecute across
      graph-shard REPLICAS — when the installed ownership map lists
      another shard whose owned partitions cover the target's, the same
      request fires at it past the hedge delay; first reply wins,
      counted replica_hedge_fired/won/wasted. Needs an ownership map
      with multi-owner partitions (elastic rebalancing) and
      hedge_delay_ms > 0 (graph shards have replicas only in an
      elastic fleet).
    prepared: prepared query plans (the read-hot-path wire saver, needs
      mux): each distinct kExecute plan (inner DAG + output names)
      registers ONCE per connection keyed by its content hash, then
      steady-state requests ship only the feed tensors stamped with the
      plan id — request bytes and server decode time stop paying for
      the plan a training loop repeats thousands of times. An unknown /
      evicted / ownership-flip-invalidated id is an explicit counted
      miss status (prepared_misses / prepared_invalidated) the client
      answers by re-preparing; pre-feature peers and prepared-off calls
      are byte-identical to today (prepared_fallbacks counts full-frame
      sends). plan_cache: server-side per-connection LRU bound on
      decoded plans. deflate_reuse: reuse one zlib deflate state per
      connection writer (deflateReset per frame, identical bytes)
      instead of a per-frame init; off restores compress2 for A/B.
    plan_optimize: run the server's prepare-time plan optimizer on every
      kPrepare registration (sub-plan dedup, filter/post-process
      pushdown, whole-plan fusion) — the optimized form executes, the
      wire and the results are byte-identical (default ON; off keeps
      the registered plan verbatim for A/B). coalesce_window_us: > 0
      lets a DETERMINISTIC prepared execute wait up to this long for
      identical requests (same plan id, graph snapshot and feed bytes,
      across connections) and answers them all from ONE execution
      (coalesced_requests / coalesce_batches). reuse_window: > 0 keeps
      that many deterministic results server-side keyed (plan, graph
      uid, feed bytes) — an identical request inside the window skips
      decode AND execute entirely (reuse_hits); every graph-epoch or
      ownership bump purges the window (reuse_invalidated), so a stale
      reply is impossible. Both default 0 = off, byte-identical wire."""
    from euler_tpu_torch.core import lib as _lib

    lib = _lib.load()
    with _rpc_mu:
        if mux is not None:
            _RPC_CONFIG["mux"] = bool(mux)
        if connections is not None:
            _RPC_CONFIG["connections"] = max(int(connections), 1)
        if compress_threshold is not None:
            _RPC_CONFIG["compress_threshold"] = max(
                int(compress_threshold), 0)
        if max_inflight is not None:
            _RPC_CONFIG["max_inflight"] = max(int(max_inflight), 1)
        if hedge_delay_ms is not None:
            _RPC_CONFIG["hedge_delay_ms"] = max(float(hedge_delay_ms), 0.0)
        if p2c is not None:
            _RPC_CONFIG["p2c"] = bool(p2c)
        if hedge_replicas is not None:
            _RPC_CONFIG["hedge_replicas"] = bool(hedge_replicas)
        if prepared is not None:
            _RPC_CONFIG["prepared"] = bool(prepared)
        if plan_cache is not None:
            _RPC_CONFIG["plan_cache"] = max(int(plan_cache), 1)
        if deflate_reuse is not None:
            _RPC_CONFIG["deflate_reuse"] = bool(deflate_reuse)
        if plan_optimize is not None:
            _RPC_CONFIG["plan_optimize"] = bool(plan_optimize)
        if coalesce_window_us is not None:
            _RPC_CONFIG["coalesce_window_us"] = max(
                int(coalesce_window_us), 0)
        if reuse_window is not None:
            _RPC_CONFIG["reuse_window"] = max(int(reuse_window), 0)
        lib.etg_rpc_config(
            -1 if mux is None else int(bool(mux)),
            0 if connections is None else max(int(connections), 1),
            -1 if compress_threshold is None else max(
                int(compress_threshold), 0),
            0 if max_inflight is None else max(int(max_inflight), 1),
            -1 if hedge_delay_ms is None else max(
                int(float(hedge_delay_ms) * 1000.0), 0),
            -1 if p2c is None else int(bool(p2c)),
            -1 if hedge_replicas is None else int(bool(hedge_replicas)),
            -1 if prepared is None else int(bool(prepared)),
            0 if plan_cache is None else max(int(plan_cache), 1),
            -1 if deflate_reuse is None else int(bool(deflate_reuse)),
            -1 if plan_optimize is None else int(bool(plan_optimize)),
            -1 if coalesce_window_us is None else max(
                int(coalesce_window_us), 0),
            -1 if reuse_window is None else max(int(reuse_window), 0))
        return dict(_RPC_CONFIG)


def configure_rpc_from_env() -> dict:
    """Apply EULER_TPU_RPC_{MUX,CONNS,COMPRESS,MAX_INFLIGHT} once per
    process (idempotent; explicit configure_rpc calls win afterwards).
    Called by RemoteGraphEngine construction so `EULER_TPU_RPC_MUX=1
    python train.py` flips a whole job without code changes."""
    import os

    global _rpc_env_applied
    with _rpc_mu:
        if _rpc_env_applied:
            return dict(_RPC_CONFIG)
    kw = {}
    if os.environ.get("EULER_TPU_RPC_MUX"):
        kw["mux"] = os.environ["EULER_TPU_RPC_MUX"] not in ("0", "")
    if os.environ.get("EULER_TPU_RPC_CONNS"):
        kw["connections"] = int(os.environ["EULER_TPU_RPC_CONNS"])
    if os.environ.get("EULER_TPU_RPC_COMPRESS"):
        kw["compress_threshold"] = int(os.environ["EULER_TPU_RPC_COMPRESS"])
    if os.environ.get("EULER_TPU_RPC_MAX_INFLIGHT"):
        kw["max_inflight"] = int(os.environ["EULER_TPU_RPC_MAX_INFLIGHT"])
    if os.environ.get("EULER_TPU_RPC_HEDGE_MS"):
        kw["hedge_delay_ms"] = float(os.environ["EULER_TPU_RPC_HEDGE_MS"])
    if os.environ.get("EULER_TPU_RPC_P2C"):
        kw["p2c"] = os.environ["EULER_TPU_RPC_P2C"] not in ("0", "")
    if os.environ.get("EULER_TPU_RPC_HEDGE_REPLICAS"):
        kw["hedge_replicas"] = (
            os.environ["EULER_TPU_RPC_HEDGE_REPLICAS"] not in ("0", ""))
    if os.environ.get("EULER_TPU_RPC_PREPARED"):
        kw["prepared"] = os.environ["EULER_TPU_RPC_PREPARED"] not in (
            "0", "")
    if os.environ.get("EULER_TPU_RPC_PLAN_CACHE"):
        kw["plan_cache"] = int(os.environ["EULER_TPU_RPC_PLAN_CACHE"])
    if os.environ.get("EULER_TPU_RPC_DEFLATE_REUSE"):
        kw["deflate_reuse"] = os.environ[
            "EULER_TPU_RPC_DEFLATE_REUSE"] not in ("0", "")
    if os.environ.get("EULER_TPU_RPC_PLAN_OPTIMIZE"):
        kw["plan_optimize"] = os.environ[
            "EULER_TPU_RPC_PLAN_OPTIMIZE"] not in ("0", "")
    if os.environ.get("EULER_TPU_RPC_COALESCE_US"):
        kw["coalesce_window_us"] = int(
            os.environ["EULER_TPU_RPC_COALESCE_US"])
    if os.environ.get("EULER_TPU_RPC_REUSE_WINDOW"):
        kw["reuse_window"] = int(os.environ["EULER_TPU_RPC_REUSE_WINDOW"])
    # apply BEFORE publishing the applied flag: a concurrently
    # constructing engine must never observe applied=True while the env
    # config has not reached the native side yet (it would build its
    # channels un-muxed for life). Racing duplicates of configure_rpc
    # are idempotent, so two first-callers applying is harmless.
    out = configure_rpc(**kw) if kw else dict(_RPC_CONFIG)
    with _rpc_mu:
        _rpc_env_applied = True
    return out


def rpc_transport_stats() -> dict:
    """Client-edge transport counters (process-global, cumulative):
    round_trips, wire bytes sent/received, the pre-compression *_raw
    views, connections_opened, compressed frame counts, mux vs v1 call
    split, hello fallbacks, and the in-flight gauge. Benches snapshot
    before/after a leg and diff."""
    from euler_tpu_torch.core import lib as _lib

    lib = _lib.load()
    out = np.zeros(len(_RPC_STAT_KEYS), dtype=np.uint64)
    lib.etg_rpc_stats(out.ctypes.data_as(_lib.c_u64p))
    return {k: int(v) for k, v in zip(_RPC_STAT_KEYS, out)}


def _ensure_rpc_obs() -> None:
    """Mirror the native transport counters into obs gauges
    (rpc_round_trips_total, rpc_bytes_{sent,received}[_raw]_total,
    rpc_inflight, ...) via a registry collector — once per process, and
    only after the native lib is known loaded (a /metrics scrape must
    never trigger a first-time build)."""
    global _rpc_obs_done
    with _rpc_mu:
        if _rpc_obs_done:
            return
        _rpc_obs_done = True
    reg = _obs.default_registry()
    gauges = {
        k: reg.gauge(
            f"rpc_{k}" if k == "inflight" else f"rpc_{k}_total",
            f"graph rpc transport {k} (client edge, process-global)")
        for k in _RPC_STAT_KEYS}

    def _collect():
        for k, v in rpc_transport_stats().items():
            gauges[k].set(v)

    reg.add_collector(_collect)


class RemoteGraphEngine:
    """GraphEngine-compatible batch sampling/feature API over a remote
    Query proxy (distribute or graph_partition mode)."""

    def __init__(self, endpoints: str, seed: int = 0,
                 mode: str = "distribute",
                 retry_deadline_s: float = 30.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 degrade: bool = False,
                 pool_size: int = 0,
                 pool_handles: Optional[int] = None,
                 pool_shared: Optional[bool] = None,
                 dedup: bool = False,
                 chunk_size: int = 4096,
                 hedge: bool = False,
                 hedge_quantile: float = 0.95,
                 hedge_min_ms: float = 1.0,
                 hedge_max_ms: float = 250.0,
                 deadline_propagation: bool = False,
                 ownership_refresh_s: float = 0.0):
        """retry_deadline_s: failover budget. A query that fails (shard
        died mid-call, RpcChannel exhausted its in-channel retries) is
        retried under RetryPolicy (exponential backoff, full jitter)
        until this deadline — the registry monitor swaps the
        replacement shard's endpoint in live, so a restarted shard
        becomes visible within its heartbeat interval and the retry
        succeeds without rebuilding the engine. 0 disables (one
        attempt). Reference semantics: rpc_client.h:46 retry counter +
        ZK watch re-resolution.

        retry_policy: full control over backoff/deadline/per-attempt
        timeout; overrides retry_deadline_s when given.

        degrade: opt-in graceful degradation — a SAMPLING query that
        exhausts its retry deadline returns default_id-padded,
        correctly-shaped results and counts the event in health()
        ["degraded"] instead of raising mid-epoch (the TF-GNN
        "countable degraded batches" production posture). Feature
        getters never degrade (silent zeros would corrupt training
        data without a trace).

        pool_size: > 0 enables the pipelined RPC client — pool_size
        worker threads over `pool_handles` (default pool_size) pooled
        query handles, exposing submit(gql, feed) -> Future and
        turning large-id-set batch calls (sample_fanout /
        sample_neighbor / get_full_neighbor / get_dense_feature) into
        concurrent per-chunk queries merged in order. Each pooled call
        still runs the full RetryPolicy/degrade machinery and
        `graph_rpc` span. 0 (default) keeps the serial one-query-at-a-
        time client.

        pool_shared: pooled query handles are SHARED by the workers
        (concurrent run() on one handle, round-robin) instead of checked
        out exclusively — the mux-transport shape: N logical in-flight
        queries over pool_handles handles (default 1) and a small fixed
        wire-connection count, instead of one fd per in-flight call.
        None (default) auto-enables exactly when the process-global mux
        transport is on (configure_rpc). Concurrent draws on a shared
        handle stay distinct (each execution takes a fresh nonce).

        dedup: in-flight request dedup — concurrent IDENTICAL
        deterministic queries (same verb + ids; feature/neighbor reads)
        coalesce onto ONE wire call, counted as rpc_dedup_hits_total.
        Sampling verbs are never coalesced. Results are byte-identical
        to independent calls (followers receive copies).

        chunk_size: id-set size above which a pooled engine splits a
        batch call into concurrent chunks (ignored without a pool).

        hedge: adaptive straggler hedging on the mux transport — a
        kExecute whose reply exceeds the hedge delay fires the SAME
        request on a second mux connection; first reply wins, the loser
        is cancelled by request_id (its late reply discarded at the
        demux reader). The delay ADAPTS: every 64 calls it is recomputed
        as the hedge_quantile of this engine's observed per-attempt
        latency histogram (graph_rpc_attempt_ms — no retries/backoff),
        clamped to [hedge_min_ms, hedge_max_ms] (the max is
        also the cold-start delay before any data). Process-global knob
        (configure_rpc) — the LAST engine to refresh wins, which is the
        right behavior for the normal one-engine-per-process case.
        Requires mux with connections >= 2; hedging off is byte-
        identical to the pre-hedging wire. Sampling semantics: both
        legs carry identical bytes, so a hedged sampling query returns
        one of two draws of the same distribution.

        deadline_propagation: stamp each attempt's REMAINING retry
        budget into the v2 request frames (hello-negotiated) so a shard
        sheds queued work that can no longer make it — counted
        deadline_shed server-side, never a silent partial. v1 peers are
        byte-unchanged; off (default) stamps nothing.

        ownership_refresh_s: > 0 enables elastic-fleet routing — the
        engine TTL-caches the registry-published epoch-versioned
        ownership map (the client-cache pattern): on the call path it
        re-fetches at most every this-many seconds, installs newer maps
        into its native proxies (splits then place ids by the map's
        owner lists, p2c over replicated partitions), REBUILDS the
        proxies when the fleet grew (a live 2→4 split), and every
        request is stamped with the map epoch so a flipped shard
        refuses stale-map reads explicitly — which this engine answers
        by a forced refresh + retry (counted stale_map_retries; zero
        silent misroutes). Needs registry endpoints ("dir:"/"tcp:");
        0 (default) keeps the static hash-routed fleet."""
        configure_rpc_from_env()  # before the native channels are built
        if ownership_refresh_s and ownership_refresh_s > 0 \
                and not _RPC_CONFIG["mux"]:
            # elastic routing NEEDS the v2 mux transport: the stale-map
            # protection rides the hello-negotiated map-epoch request
            # prefix, which the classic v1 framing cannot carry — an
            # unstamped request would be served silently by a flipped
            # shard. Forced here, before the channels are built.
            configure_rpc(mux=True)
        self.query = Query.remote(endpoints, seed=seed, mode=mode)
        # elastic fleet: TTL-cached registry-published ownership map
        self._endpoints = endpoints
        self._seed = seed
        self._mode = mode
        self.ownership_refresh_s = float(ownership_refresh_s)
        self._omap_mu = threading.Lock()
        # serializes fetch+install+rebuild: two threads hitting the
        # stale-map path at once must not both rebuild (the second
        # would close the first's freshly built pipeline)
        self._omap_refresh_mu = threading.Lock()
        self._omap_epoch = 0
        self._omap_spec: Optional[str] = None
        self._omap_next_check = 0.0
        # proxies/pipelines retired by a fleet-growth rebuild: kept
        # alive (not closed) because in-flight calls on other threads —
        # including the rebuild trigger itself, when it fires on a
        # pooled worker — may still hold them; engine.close() closes
        # them once
        self._retired_proxies: list = []
        self._retired_pipelines: list = []
        self.retry = retry_policy or RetryPolicy(
            deadline_s=float(retry_deadline_s))
        # tail-latency knobs: adaptive hedging + deadline
        # propagation — both opt-in, both no-ops on the wire when off
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_max_ms = float(hedge_max_ms)
        self.deadline_propagation = bool(deadline_propagation)
        self._hedge_calls = 0  # refresh cadence counter (under _health_mu)
        if self.hedge:
            # arm at the conservative cold-start delay; the histogram
            # takes over from the first refresh
            configure_rpc(hedge_delay_ms=self.hedge_max_ms)
        self.retry_deadline_s = self.retry.deadline_s  # back-compat alias
        self.degrade = bool(degrade)
        # host-side rng for the client-computed node2vec bias; seed=0 →
        # fresh entropy (matching the engine's seed convention)
        self._rng = np.random.default_rng(seed if seed else None)
        self._backoff_rng = random.Random(seed ^ 0x5EED if seed else None)
        self._health_mu = threading.Lock()
        # counters live on the obs registry (labeled by engine instance);
        # health() is a VIEW over them — no parallel bookkeeping
        self._obs_name = f"remote{next(_ENGINE_IDS)}"
        reg = _obs.default_registry()
        lab = {"engine": self._obs_name}
        self._ctr = {
            k: reg.counter(f"graph_rpc_{k}_total", h,
                           ("engine",)).labels(**lab)
            for k, h in _RPC_COUNTERS.items()}
        self._ctr_backoff_s = reg.counter(
            "graph_rpc_backoff_seconds_total",
            "seconds slept in retry backoff", ("engine",)).labels(**lab)
        self._hist_call_ms = reg.histogram(
            "graph_rpc_ms", "end-to-end graph rpc latency incl. retries",
            ("engine",)).labels(**lab)
        # per-ATTEMPT wire latency (no retries, no backoff sleeps):
        # the adaptive hedge delay reads its quantiles here — the
        # end-to-end histogram above would inflate the delay with
        # backoff exactly when stragglers/failures abound
        self._hist_attempt_ms = reg.histogram(
            "graph_rpc_attempt_ms",
            "single-attempt graph rpc wire latency (hedge-delay signal)",
            ("engine",)).labels(**lab)
        self._last_error: Optional[str] = None
        # elastic fleet observability: the installed map epoch and the
        # per-shard request counters (hot-shard detection feeds off
        # graph_shard_requests_total at every scrape)
        self._g_map_epoch = reg.gauge(
            "graph_ownership_epoch",
            "installed ownership-map epoch (0 = hash routing)",
            ("engine",)).labels(**lab)
        self._g_shard_reqs = reg.gauge(
            "graph_shard_requests_total",
            "kExecute requests issued per graph shard (client edge)",
            ("engine", "shard"))
        self._g_shard_rows = reg.gauge(
            "graph_shard_rows_total",
            "split-routed ids per graph shard (client edge — the "
            "hot-shard detection signal)", ("engine", "shard"))
        eng_ref = weakref.ref(self)
        obs_name = self._obs_name
        g_reqs, g_rows = self._g_shard_reqs, self._g_shard_rows

        def _collect_shards():
            eng = eng_ref()
            if eng is None:
                return False  # engine gone: collector self-removes
            try:
                reqs, rows = eng.query.shard_stats()
            except (EngineError, OSError):
                return None  # closed/unavailable; keep the collector
            for s in range(len(reqs)):
                g_reqs.labels(engine=obs_name, shard=str(s)).set(
                    int(reqs[s]))
                g_rows.labels(engine=obs_name, shard=str(s)).set(
                    int(rows[s]))

        reg.add_collector(_collect_shards)
        _obs.register_health(self._obs_name, self.health)
        self.query.bind_obs(self._obs_name)
        self._strays: list = []  # abandoned timed-out attempt threads
        _ensure_rpc_obs()
        # in-flight dedup: deterministic sub-queries coalesce onto one
        # wire call (graph/pipeline.py); None keeps every call 1:1
        self._dedup = None
        if dedup:
            from euler_tpu_torch.graph.pipeline import InflightDedup

            self._dedup = InflightDedup(self._obs_name)
        # pipelined client: per-engine worker pool + pooled
        # query handles; None keeps the serial path byte-identical
        self.chunk_size = int(chunk_size)
        self.pipeline = None
        self._pipeline_args = None
        if pool_size and pool_size > 0:
            from euler_tpu_torch.graph.pipeline import PipelinedClient

            shared = (_RPC_CONFIG["mux"] if pool_shared is None
                      else bool(pool_shared))
            # retained for proxy rebuilds after a fleet-growth refresh
            self._pipeline_args = dict(workers=int(pool_size),
                                       handles=pool_handles,
                                       shared=shared)
            self.pipeline = PipelinedClient(
                self, endpoints, seed, mode, **self._pipeline_args)
        if self.ownership_refresh_s > 0:
            # best-effort initial install (the fleet may predate maps);
            # runs after the pipeline exists so pooled handles get it
            try:
                self.refresh_ownership(force=True)
            except (EngineError, OSError, ValueError):
                pass

    # -- health / retry machinery ------------------------------------------
    def health(self) -> dict:
        """Counter surface for ops/bench artifacts: calls, retries (sleep
        cycles), failovers (calls that failed then succeeded on retry),
        degraded (padded results served), deadline_exhausted, last_error,
        plus the proxy's own query/error totals. A compatibility VIEW
        over this engine's euler_tpu_torch.obs registry children — the same
        numbers a /metrics scrape reports, by construction."""
        out = {k: int(self._ctr[k].value) for k in
               ("calls", "retries", "failovers", "degraded",
                "deadline_exhausted", "stale_map_retries",
                "ownership_refreshes")}
        with self._health_mu:
            out["last_error"] = self._last_error
        try:
            out.update({f"proxy_{k}": v
                        for k, v in self.query.stats().items()
                        if k in ("queries", "errors")})
        except (EngineError, OSError):
            # closed / stats unavailable — the merge failure is COUNTED
            # (it was silently swallowed pre-obs), local counters still
            # serve
            self._ctr["health_merge_errors"].inc()
        out["health_merge_errors"] = int(
            self._ctr["health_merge_errors"].value)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        self._ctr[key].inc(n)

    # bound on live abandoned attempt threads: past this, timed attempts
    # fail fast instead of spawning — a long black-holed outage with
    # degrade=True must not accumulate threads/sockets without limit
    _MAX_STRAYS = 32

    def _attempt(self, gql: str, feed, query=None, deadline_ms=None,
                 trace=None):
        """One query attempt, bounded by retry.call_timeout_s when set
        (the RPC sockets block, so a black-holed connection can only be
        escaped by abandoning the attempt thread). `query` selects a
        pooled handle; None uses the engine's own. deadline_ms and the
        wire trace context ride to the shards inside the v2 frames
        (Query.run)."""
        query = query if query is not None else self.query
        t = self.retry.call_timeout_s
        t_att = time.monotonic()
        if not t or t <= 0:
            out = query.run(gql, feed, deadline_ms=deadline_ms,
                            trace=trace)
            self._hist_attempt_ms.observe(
                (time.monotonic() - t_att) * 1000.0)
            return out
        with self._health_mu:
            # reap strays that have since unblocked; refuse to grow past
            # the cap ("timeout" marker keeps this retryable/degradable)
            self._strays = [th for th in self._strays if th.is_alive()]
            if len(self._strays) >= self._MAX_STRAYS:
                raise EngineError(
                    f"graph rpc attempt timeout: {len(self._strays)} "
                    "abandoned in-flight attempts already parked "
                    "(endpoint black-holed?); refusing to spawn more")
        box = {}

        def work():
            try:
                box["out"] = query.run(gql, feed, deadline_ms=deadline_ms,
                                       trace=trace)
            except BaseException as e:  # surfaced on join below
                box["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(t)
        if th.is_alive():
            with self._health_mu:
                self._strays.append(th)
            raise EngineError(
                f"graph rpc attempt timeout after {t:.3f}s "
                "(in-flight attempt abandoned)")
        if "err" in box:
            raise box["err"]
        self._hist_attempt_ms.observe((time.monotonic() - t_att) * 1000.0)
        return box["out"]

    def _run(self, gql: str, feed=None, query=None):
        """_run_wire with in-flight dedup in front when enabled:
        concurrent identical DETERMINISTIC queries (never sampling
        verbs) coalesce onto one wire call; followers get byte-
        identical copies of the leader's result."""
        if self._dedup is not None:
            return self._dedup.run(
                gql, feed, lambda: self._run_wire(gql, feed, query))
        return self._run_wire(gql, feed, query)

    def _run_wire(self, gql: str, feed=None, query=None):
        """query.run under RetryPolicy: retryable (transport) failures
        back off with full jitter until the deadline; semantic errors
        raise at once; an exhausted budget raises
        RetryDeadlineExceeded. The whole call (retries + backoff
        included) runs under a `graph_rpc` span and lands in the
        graph_rpc_ms histogram, success or raise. `query` runs the
        attempts on a pooled handle (the pipelined client's workers);
        default is the engine's own handle."""
        pol = self.retry
        self._bump("calls")
        if self.ownership_refresh_s > 0:
            # TTL tick: within the TTL this is one lock + compare; past
            # it, one registry fetch amortized over the window
            try:
                self.refresh_ownership()
            except (EngineError, OSError, ValueError):
                pass  # stale map still routes; the shard-side check
                # + forced refresh below stay the correctness backstop
        with _obs.timed_span("graph_rpc", self._hist_call_ms,
                             engine=self._obs_name, gql=gql[:80]) as sp:
            deadline = time.monotonic() + max(pol.deadline_s, 0.0)
            attempt = 0
            # wire trace context: every attempt (and every hedge leg the
            # native layer fires) carries THIS span's (trace_id,
            # span_id), so the shards' timing breakdowns stitch under
            # the graph_rpc span in a merged chrome trace. 0 when
            # tracing is disabled — nothing is stamped on the wire.
            wire_trace = (sp.trace_id, sp.span_id)
            while True:
                try:
                    dl_ms = None
                    if self.deadline_propagation:
                        # each attempt ships the budget REMAINING now —
                        # a shard sheds it once it can no longer make it
                        dl_ms = max(
                            (deadline - time.monotonic()) * 1000.0, 1.0)
                    out = self._attempt(gql, feed, query,
                                        deadline_ms=dl_ms,
                                        trace=wire_trace)
                    if attempt:
                        # the call came back after ≥1 transport failure:
                        # the shard (or its replacement channel)
                        # recovered
                        self._bump("failovers")
                    sp.set(attempts=attempt + 1)
                    if self.hedge:
                        self._maybe_refresh_hedge()
                    return out
                except EngineError as e:
                    if not retryable_error(e):
                        raise
                    if "stale ownership map" in str(e).lower():
                        # the shard flipped to a newer map than this
                        # request was split with: refresh NOW (forced)
                        # so the retry routes on the fresh map — the
                        # split/merge plan re-runs from scratch
                        self._bump("stale_map_retries")
                        try:
                            self.refresh_ownership(force=True)
                        except (EngineError, OSError, ValueError):
                            pass  # retry anyway; backoff paces us
                        # a POOLED handle may now be retired (fleet-
                        # growth rebuild): it can never adopt the wider
                        # map, so every retry on it would be refused —
                        # re-point the remaining attempts at the
                        # engine's fresh proxy
                        if query is not None and query is not self.query:
                            query = None
                    attempt += 1
                    with self._health_mu:
                        self._last_error = str(e)
                    now = time.monotonic()
                    exhausted = (now >= deadline
                                 or (pol.max_attempts
                                     and attempt >= pol.max_attempts))
                    if exhausted:
                        self._bump("deadline_exhausted")
                        sp.set(attempts=attempt, exhausted=True)
                        raise RetryDeadlineExceeded(
                            f"graph rpc gave up after {attempt} "
                            f"attempt(s) ({pol.deadline_s:.1f}s "
                            f"deadline): {e}") from e
                    self._bump("retries")
                    sleep = min(
                        pol.backoff_s(attempt, self._backoff_rng),
                        max(deadline - now, 0.0))
                    with _obs.span("graph_rpc_backoff",
                                   engine=self._obs_name,
                                   attempt=attempt):
                        time.sleep(sleep)
                    self._ctr_backoff_s.inc(sleep)

    def _note_degraded(self) -> None:
        self._bump("degraded")

    # -- elastic fleet: ownership-map cache / refresh ----------------------
    def ownership_epoch(self) -> int:
        """Installed ownership-map epoch (0 = hash routing)."""
        return self.query.ownership_epoch()

    def shard_traffic(self):
        """(requests, rows) per-shard uint64 arrays since the current
        proxy was built. ROWS (split-routed ids) are the hot-shard
        signal — the distribute rewrite fires one REMOTE per shard per
        query regardless, so requests alone cannot see skew. Mirrored
        as graph_shard_{requests,rows}_total{engine=,shard=} gauges."""
        return self.query.shard_stats()


    def _registry_endpoints(self) -> Optional[str]:
        return (self._endpoints
                if self._endpoints.startswith(("dir:", "tcp:")) else None)

    def refresh_ownership(self, force: bool = False) -> int:
        """TTL-cached ownership-map refresh (the client-cache
        pattern): fetch the registry-published map, and when it is
        newer than the installed one push it into the native proxies —
        REBUILDING them first when the map references a grown fleet
        (live split). force=True skips the TTL (the stale-map retry
        path). Returns the installed epoch. No-op without registry
        endpoints or a published map."""
        registry = self._registry_endpoints()
        if registry is None:
            return 0
        now = time.monotonic()
        with self._omap_mu:
            if not force and now < self._omap_next_check:
                return self._omap_epoch
            # claim the slot before the fetch so concurrent callers
            # don't stampede the registry
            self._omap_next_check = now + max(self.ownership_refresh_s,
                                              0.5)
        from euler_tpu_torch.graph import elastic

        # ONE refresh at a time: concurrent stale-map retries must not
        # both rebuild the proxies (the loser would close the winner's
        # fresh pipeline); late arrivals re-check the epoch inside and
        # return the already-installed map
        with self._omap_refresh_mu:
            m = elastic.fetch_map(registry)
            if m is None:
                return 0
            with self._omap_mu:
                if m.map_epoch <= self._omap_epoch:
                    return self._omap_epoch
            if m.shard_num != self.query.shard_num():
                # the fleet grew (or shrank): these proxies were built
                # against the wrong channel set — rebuild from discovery
                self._rebuild_proxies()
            spec = m.encode()
            self.query.set_ownership(spec)
            if self.pipeline is not None:
                self.pipeline.set_ownership(spec)
            with self._omap_mu:
                self._omap_epoch = m.map_epoch
                self._omap_spec = spec
        self._bump("ownership_refreshes")
        self._g_map_epoch.set(m.map_epoch)
        return m.map_epoch

    def _rebuild_proxies(self) -> None:
        """Swap in fresh native proxies discovered from the registry
        (new shard count after a live split). The retired proxies AND
        the retired pipeline are kept alive, not closed: this can run
        ON one of the old pipeline's own worker threads (the stale-map
        retry path), where close() would try to join the current
        thread, and cancelling the old pool's queued futures would
        fail calls that are mid-retry. Old workers drain naturally —
        their in-flight calls re-point at the fresh proxy (the
        stale-map hook in _run_wire) — and everything retired is
        closed with the engine."""
        fresh = Query.remote(self._endpoints, seed=self._seed,
                             mode=self._mode)
        old, self.query = self.query, fresh
        self._retired_proxies.append(old)
        self.query.bind_obs(self._obs_name)
        if self.pipeline is not None:
            from euler_tpu_torch.graph.pipeline import PipelinedClient

            old_pipe = self.pipeline
            self.pipeline = PipelinedClient(
                self, self._endpoints, self._seed, self._mode,
                **self._pipeline_args)
            self._retired_pipelines.append(old_pipe)

    # -- adaptive hedging --------------------------------------------------
    _HEDGE_REFRESH_CALLS = 64

    def _maybe_refresh_hedge(self) -> None:
        """Every _HEDGE_REFRESH_CALLS successful calls, recompute the
        process-global hedge delay as the hedge_quantile of THIS
        engine's per-attempt latency histogram (bucket-interpolated),
        clamped to [hedge_min_ms, hedge_max_ms] — the adaptive
        percentile the straggler detector fires at."""
        with self._health_mu:
            self._hedge_calls += 1
            if self._hedge_calls % self._HEDGE_REFRESH_CALLS:
                return
        self.update_hedge_delay()

    def update_hedge_delay(self) -> float:
        """Force one adaptive-hedge-delay refresh; returns the applied
        delay in ms (also pushed into the process-global RpcConfig)."""
        q = self._hist_attempt_ms.quantile(self.hedge_quantile)
        delay = self.hedge_max_ms if q is None else min(
            max(float(q), self.hedge_min_ms), self.hedge_max_ms)
        configure_rpc(hedge_delay_ms=delay)
        return delay

    # -- pipelined submission / chunked intra-batch fan-out ----------------
    def submit(self, gql: str, feed=None):
        """Future-returning query submission. With a pool (pool_size>0)
        the call queues to the worker pool and runs on a pooled handle;
        without one it executes synchronously and returns an already-
        completed Future — one surface either way."""
        pipe = self.pipeline
        if pipe is not None:
            try:
                return pipe.submit(gql, feed)
            except RuntimeError:
                # the pipeline was closed under us by a fleet-growth
                # proxy rebuild: fall through to the synchronous path
                # for this call (the rebuilt pipeline serves the next)
                pass
        from concurrent.futures import Future

        fut = Future()
        try:
            fut.set_result(self._run(gql, feed))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def _id_chunks(self, n: int):
        """[(lo, hi)] chunk bounds when the pipelined client should fan
        an id set out concurrently; None → serial single call (no pool,
        chunking disabled, or the set is small enough already)."""
        c = self.chunk_size
        if self.pipeline is None or c <= 0 or n <= c:
            return None
        return [(i, min(i + c, n)) for i in range(0, n, c)]

    def _chunk_results(self, chunks, submit_chunk, can_degrade=True):
        """Submit every chunk, then collect results IN CHUNK ORDER. With
        degrade=True a degradable (sampling) chunk that exhausts its
        retry deadline yields None (the caller pads exactly that id
        range); otherwise the first failure raises after all futures
        were issued — in-flight siblings finish on their workers and
        are dropped. can_degrade=False for verbs that never degrade
        (feature/neighbor getters), matching the serial path."""
        futs = [submit_chunk(a, b) for a, b in chunks]
        outs = []
        for f in futs:
            try:
                outs.append(f.result())
            except RetryDeadlineExceeded:
                if not (can_degrade and self.degrade):
                    raise
                self._note_degraded()
                outs.append(None)
        return outs

    # -- root sampling -----------------------------------------------------
    def sample_node(self, count: int, node_type: int = -1) -> np.ndarray:
        out = self._run(f"sampleN({node_type}, {count}).as(n)")
        return out["n:0"].astype(np.uint64).ravel()

    def sample_edge(self, count: int, edge_type: int = -1):
        out = self._run(f"sampleE({edge_type}, {count}).as(e)")
        return (out["e:0"].astype(np.uint64), out["e:1"].astype(np.uint64),
                out["e:2"].astype(np.int32))

    def sample_node_with_types(self, types) -> np.ndarray:
        """One weighted node draw per requested type (reference
        SampleNWithTypes) via the sampleNWithTypes verb."""
        types = np.ascontiguousarray(types, dtype=np.int32).ravel()
        out = self._run("sampleNWithTypes(t).as(n)", {"t": types})
        return out["n:0"].astype(np.uint64).ravel()

    # -- traversal ---------------------------------------------------------
    @staticmethod
    def _et(edge_types) -> str:
        from euler_tpu_torch.gql import edge_types_str

        return edge_types_str(edge_types)

    def sample_fanout(self, roots, counts: Sequence[int], edge_types=None,
                      default_id: int = 0):
        """Multi-hop expansion in ONE round trip (reference
        sample_fanout_op.cc:36-48). Returns (ids_per_hop, w_per_hop,
        t_per_hop) with hop i arrays of shape [n·prod(counts[:i+1])]."""
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        if edge_types is not None and len(edge_types) > 0 and isinstance(
                edge_types[0], (list, tuple, np.ndarray)):
            if len(edge_types) != len(counts):
                raise ValueError(
                    f"per-hop edge_types has {len(edge_types)} entries, "
                    f"expected {len(counts)} (one per hop)")
            per_hop = [self._et(h) for h in edge_types]
        else:
            per_hop = [self._et(edge_types)] * len(counts)
        q = "v(r)"
        for i, k in enumerate(counts):
            q += f".sampleNB({per_hop[i]}, {int(k)}, {default_id}).as(h{i})"
        chunks = self._id_chunks(roots.size)
        if chunks is None:
            try:
                out = self._run(q, {"r": roots})
            except RetryDeadlineExceeded:
                if not self.degrade:
                    raise
                self._note_degraded()
                ids, w, t = [], [], []
                m = roots.size
                for k in counts:
                    m *= int(k)
                    ids.append(np.full(m, default_id, np.uint64))
                    w.append(np.zeros(m, np.float32))
                    t.append(np.full(m, -1, np.int32))
                return ids, w, t
            ids = [out[f"h{i}:1"].astype(np.uint64)
                   for i in range(len(counts))]
            w = [out[f"h{i}:2"].astype(np.float32)
                 for i in range(len(counts))]
            t = [out[f"h{i}:3"].astype(np.int32)
                 for i in range(len(counts))]
            return ids, w, t
        # concurrent fan-out: hop arrays are root-major, so per-chunk
        # hop arrays concatenate into exactly the unchunked layout
        outs = self._chunk_results(
            chunks, lambda a, b: self.submit(q, {"r": roots[a:b]}))
        ids, w, t = [], [], []
        mult = 1
        for i, k in enumerate(counts):
            mult *= int(k)
            pi, pw, pt = [], [], []
            for (a, b), out in zip(chunks, outs):
                m = (b - a) * mult
                if out is None:          # this chunk degraded: pad it
                    pi.append(np.full(m, default_id, np.uint64))
                    pw.append(np.zeros(m, np.float32))
                    pt.append(np.full(m, -1, np.int32))
                else:
                    pi.append(out[f"h{i}:1"].astype(np.uint64))
                    pw.append(out[f"h{i}:2"].astype(np.float32))
                    pt.append(out[f"h{i}:3"].astype(np.int32))
            ids.append(np.concatenate(pi))
            w.append(np.concatenate(pw))
            t.append(np.concatenate(pt))
        return ids, w, t

    def sample_neighbor(self, ids, count: int, edge_types=None,
                        default_id: int = 0):
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        n = ids.size
        gql = (f"v(r).sampleNB({self._et(edge_types)}, {count}, "
               f"{default_id}).as(nb)")
        chunks = self._id_chunks(n)
        if chunks is None:
            try:
                out = self._run(gql, {"r": ids})
            except RetryDeadlineExceeded:
                if not self.degrade:
                    raise
                self._note_degraded()
                return (np.full((n, count), default_id, np.uint64),
                        np.zeros((n, count), np.float32),
                        np.full((n, count), -1, np.int32))
            return (out["nb:1"].reshape(n, count).astype(np.uint64),
                    out["nb:2"].reshape(n, count).astype(np.float32),
                    out["nb:3"].reshape(n, count).astype(np.int32))
        outs = self._chunk_results(
            chunks, lambda a, b: self.submit(gql, {"r": ids[a:b]}))
        nb = np.full((n, count), default_id, np.uint64)
        w = np.zeros((n, count), np.float32)
        t = np.full((n, count), -1, np.int32)
        for (a, b), out in zip(chunks, outs):
            if out is None:
                continue                 # degraded chunk keeps padding
            m = b - a
            nb[a:b] = out["nb:1"].reshape(m, count).astype(np.uint64)
            w[a:b] = out["nb:2"].reshape(m, count).astype(np.float32)
            t[a:b] = out["nb:3"].reshape(m, count).astype(np.int32)
        return nb, w, t

    def get_full_neighbor(self, ids, edge_types=None,
                          sorted_by_id: bool = False,
                          in_edges: bool = False):
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        verb = "getRNB" if in_edges else (
            "getSortedNB" if sorted_by_id else "getNB")
        gql = f"v(r).{verb}({self._et(edge_types)}).as(nb)"
        chunks = self._id_chunks(ids.size)
        if chunks is None:
            out = self._run(gql, {"r": ids})
            idx = out["nb:0"].reshape(-1, 2)
            offsets = np.concatenate([[0], idx[:, 1]]).astype(np.uint64)
            return (offsets, out["nb:1"].astype(np.uint64),
                    out["nb:2"].astype(np.float32),
                    out["nb:3"].astype(np.int32))
        # neighbor getters never degrade, so a failed chunk raises
        outs = self._chunk_results(
            chunks, lambda a, b: self.submit(gql, {"r": ids[a:b]}),
            can_degrade=False)
        offs, nbrs, ws, ts = [np.zeros(1, np.int64)], [], [], []
        base = 0
        for out in outs:
            idx = out["nb:0"].reshape(-1, 2).astype(np.int64)
            offs.append(idx[:, 1] + base)
            base += int(idx[-1, 1]) if idx.size else 0
            nbrs.append(out["nb:1"].astype(np.uint64))
            ws.append(out["nb:2"].astype(np.float32))
            ts.append(out["nb:3"].astype(np.int32))
        return (np.concatenate(offs).astype(np.uint64),
                np.concatenate(nbrs), np.concatenate(ws),
                np.concatenate(ts))

    def get_neighbor_edges(self, ids, edge_types=None):
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        out = self._run(
            f"v(r).outE({self._et(edge_types)}).as(e)", {"r": ids})
        idx = out["e:0"].reshape(-1, 2)
        offsets = np.concatenate([[0], idx[:, 1]]).astype(np.uint64)
        return (offsets, out["e:1"].astype(np.uint64),
                out["e:2"].astype(np.uint64), out["e:3"].astype(np.int32),
                out["e:4"].astype(np.float32))

    def sample_layerwise(self, roots, layer_sizes: Sequence[int],
                         edge_types=None, default_id: int = 0,
                         weight_func: str = ""):
        """LADIES pools from the cluster via one sampleLNB query
        (reference SampleNeighborLayerwiseWithAdj → API_SAMPLE_L).
        weight_func '' or 'sqrt' (hub-dampening, reference
        local_sample_layer_op.cc:94). Note: in distribute mode sqrt is
        applied to each shard's partial accumulation (the reference's
        distributed semantics too) — see POOL_MERGE in
        kernels_dist.cc."""
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        sizes = ":".join(str(int(s)) for s in layer_sizes)
        wf = f", {weight_func}" if weight_func else ""
        try:
            out = self._run(
                f"v(r).sampleLNB({self._et(edge_types)}, {sizes}, "
                f"{default_id}{wf}).as(l)", {"r": roots})
        except RetryDeadlineExceeded:
            if not self.degrade:
                raise
            self._note_degraded()
            return [np.full(int(s), default_id, np.uint64)
                    for s in layer_sizes]
        return [out[f"l:{i}"].astype(np.uint64)
                for i in range(len(layer_sizes))]

    def random_walk(self, roots, walk_len: int, p: float = 1.0,
                    q: float = 1.0, edge_types=None,
                    default_id: int = 0) -> np.ndarray:
        """[n, walk_len+1] walks against the cluster. The unbiased case
        is ONE chained-sampleNB round trip; node2vec bias (p/q) falls
        back to per-step neighbor queries with client-side reweighting —
        the reference's random_walk_op.cc:70-110 approach."""
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        n = roots.size
        et = self._et(edge_types)
        out = np.zeros((n, walk_len + 1), dtype=np.uint64)
        out[:, 0] = roots
        if p == 1.0 and q == 1.0:
            gql = "v(r)" + "".join(
                f".sampleNB({et}, 1, {default_id}).as(s{i})"
                for i in range(walk_len))
            try:
                res = self._run(gql, {"r": roots})
            except RetryDeadlineExceeded:
                if not self.degrade:
                    raise
                self._note_degraded()
                out[:, 1:] = default_id  # roots stay real; steps padded
                return out
            for i in range(walk_len):
                out[:, i + 1] = res[f"s{i}:1"].astype(np.uint64)
            return out
        rng = self._rng
        prev = np.zeros(n, dtype=np.uint64)
        cur = roots.copy()
        # neighbor lists of `prev` are the previous step's `cur` lists —
        # cache them instead of refetching (halves the per-step RPCs)
        poff = np.zeros(n + 1, dtype=np.int64)
        pnbr = np.zeros(0, dtype=np.uint64)
        for step in range(walk_len):
            try:
                off, nbr, w, _ = self.get_full_neighbor(
                    cur, edge_types=edge_types)
            except RetryDeadlineExceeded:
                if not self.degrade:
                    raise
                self._note_degraded()
                out[:, step + 1:] = default_id  # remaining steps padded
                return out
            off = off.astype(np.int64)
            nxt = self._biased_step(off, nbr, w, prev, poff, pnbr,
                                    p, q, default_id, rng)
            prev, cur = cur, nxt
            poff, pnbr = off, nbr
            out[:, step + 1] = cur
        return out

    @staticmethod
    def _biased_step(off, nbr, w, prev, poff, pnbr, p, q, default_id,
                     rng) -> np.ndarray:
        """One node2vec-biased walk step, fully vectorized (the per-node
        Python loop with a set() per row was the walk feeder's host
        ceiling): candidate weights are reweighted with numpy segment
        ops — the prev-neighbor membership test is a sorted-rank
        searchsorted over (row, id) composite keys, the draw a
        segment-sum + segmented inverse-CDF over one global cumsum.
        Distribution-identical to the loop (pinned by the seeded
        chi-squared test in tests/test_host_pipeline.py); rows with no
        candidates or zero total weight stay at default_id."""
        n = prev.size
        counts = off[1:] - off[:-1]
        nxt = np.full(n, default_id, dtype=np.uint64)
        if nbr.size == 0:
            return nxt
        seg = np.repeat(np.arange(n, dtype=np.int64), counts)
        wt = w.astype(np.float64)
        # return edge: candidate == the walk's previous node
        ret = nbr == prev[seg]
        # outward edge: candidate NOT adjacent to the previous node.
        # Sorted-membership: rank every id against the union of ids
        # seen this step, pack (row, rank) into one int64 key, and
        # binary-search the sorted prev-neighbor keys — no per-row set.
        uniq = np.unique(np.concatenate([nbr, pnbr]))
        stride = np.int64(uniq.size + 1)
        cand_key = seg * stride + np.searchsorted(uniq, nbr)
        pseg = np.repeat(np.arange(n, dtype=np.int64),
                         poff[1:] - poff[:-1])
        prev_key = np.sort(pseg * stride + np.searchsorted(uniq, pnbr))
        if prev_key.size:
            ins = np.minimum(np.searchsorted(prev_key, cand_key),
                             prev_key.size - 1)
            member = prev_key[ins] == cand_key
        else:
            member = np.zeros(nbr.size, dtype=bool)
        wt[ret] /= p
        wt[~ret & ~member] /= q
        # segment totals + segmented inverse-CDF draw on the global
        # cumulative sum: row i's draw lands in [off[i], off[i+1])
        s = np.bincount(seg, weights=wt, minlength=n)
        cum = np.cumsum(wt)
        start = np.concatenate([[0.0], cum])[off[:-1]]
        ok = s > 0
        u = rng.random(n) * s
        pos = np.searchsorted(cum, start + u, side="right")
        pos = np.minimum(pos, np.maximum(off[1:] - 1, 0))
        nxt[ok] = nbr[pos[ok]]
        return nxt

    # -- features ----------------------------------------------------------
    def _dense_from_values(self, out, n: int, names, dims, single: bool):
        """Decode a values() query's (idx, vals) pairs into dense [n, d]
        arrays. Rows can be ragged (graph_partition mode returns EMPTY
        rows for ids a shard doesn't own) — scatter by the idx offsets
        instead of a flat reshape, zero-filling misses like the embedded
        engine does. Shared by the node and edge dense getters."""
        outs = []
        dim_list = ([dims] if single else list(dims)) if dims is not None \
            else [None] * len(names)
        for i, want in enumerate(dim_list):
            idx = out[f"f:{2 * i}"].reshape(-1, 2).astype(np.int64)
            vals = out[f"f:{2 * i + 1}"].astype(np.float32)
            lens = idx[:, 1] - idx[:, 0]
            dim = int(want) if want is not None else int(lens.max(initial=0))
            # fast path (the distribute-mode norm): every row complete
            # and laid out contiguously → one reshape, no Python loop
            # on the feeder path
            if (idx.shape[0] == n and vals.size == n * dim
                    and (lens == dim).all()
                    and (idx[:, 0] == np.arange(n) * dim).all()):
                outs.append(vals.reshape(n, dim))
                continue
            # ragged slow path (graph_partition mode: shards return
            # EMPTY rows for ids they don't own): one repeat/scatter
            # pass instead of a per-row copy loop
            arr = np.zeros((n, dim), dtype=np.float32)
            k = min(n, idx.shape[0])
            cnt = np.minimum(lens[:k], dim).astype(np.int64)
            tot = int(cnt.sum())
            if tot:
                rows = np.repeat(np.arange(k), cnt)
                col = (np.arange(tot, dtype=np.int64)
                       - np.repeat(np.cumsum(cnt) - cnt, cnt))
                arr[rows, col] = vals[np.repeat(idx[:k, 0], cnt) + col]
            outs.append(arr)
        return outs[0] if single else outs

    def get_dense_feature(self, ids, fids, dims=None):
        """[n, dim] float32 per fid; mirrors GraphEngine.get_dense_feature
        (single name → single array, list → list)."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        single = not isinstance(fids, (list, tuple, np.ndarray))
        names = [fids] if single else list(fids)
        q = "v(r).values(" + ", ".join(str(n) for n in names) + ").as(f)"
        chunks = self._id_chunks(ids.size)
        if chunks is None:
            out = self._run(q, {"r": ids})
            return self._dense_from_values(out, ids.size, names, dims,
                                           single)
        outs = self._chunk_results(
            chunks, lambda a, b: self.submit(q, {"r": ids[a:b]}),
            can_degrade=False)
        # decode each chunk as a list, then merge per fid; with
        # dims=None a chunk's inferred width is its own rows' max, so
        # right-pad to the cross-chunk max — rows are zero-filled past
        # their length either way, byte-identical to the single query
        dim_list = None if dims is None else ([dims] if single
                                              else list(dims))
        per_chunk = [self._dense_from_values(out, b - a, names, dim_list,
                                             False)
                     for (a, b), out in zip(chunks, outs)]
        merged = []
        for i in range(len(names)):
            parts = [pc[i] for pc in per_chunk]
            width = max(p.shape[1] for p in parts)
            parts = [p if p.shape[1] == width else np.pad(
                p, ((0, 0), (0, width - p.shape[1]))) for p in parts]
            merged.append(np.concatenate(parts))
        return merged[0] if single else merged

    @staticmethod
    def _csr_result(out, tag: str, dtype):
        """(offsets[n+1], values) from a values() query's (idx, vals)
        pair — the CSR convention the embedded engine's sparse/binary
        getters return."""
        idx = out[f"{tag}:0"].reshape(-1, 2).astype(np.int64)
        offsets = np.concatenate([[0], idx[:, 1]]).astype(np.uint64)
        return offsets, out[f"{tag}:1"].astype(dtype)

    def get_sparse_feature(self, ids, fid) -> tuple:
        """(offsets[n+1], u64 values) CSR; mirrors
        GraphEngine.get_sparse_feature over the cluster."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        out = self._run(f"v(r).values({fid}).as(p)", {"r": ids})
        return self._csr_result(out, "p", np.uint64)

    def get_binary_feature(self, ids, fid) -> tuple:
        """(offsets[n+1], bytes) CSR of raw per-node byte strings."""
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        out = self._run(f"v(r).values({fid}).as(p)", {"r": ids})
        offs, vals = self._csr_result(out, "p", np.uint8)
        return offs, vals.tobytes()

    def get_edge_dense_feature(self, src, dst, types, fids, dims=None):
        """[n, dim] float32 per fid for (src, dst, type) edge triples."""
        feed = {"batch:0": np.ascontiguousarray(src, np.uint64).ravel(),
                "batch:1": np.ascontiguousarray(dst, np.uint64).ravel(),
                "batch:2": np.ascontiguousarray(types, np.int32).ravel()}
        single = not isinstance(fids, (list, tuple, np.ndarray))
        names = [fids] if single else list(fids)
        q = "e(batch).values(" + ", ".join(str(n) for n in names) + ").as(f)"
        out = self._run(q, feed)
        return self._dense_from_values(out, feed["batch:0"].size, names,
                                       dims, single)

    def get_edge_sparse_feature(self, src, dst, types, fid) -> tuple:
        feed = {"batch:0": np.ascontiguousarray(src, np.uint64).ravel(),
                "batch:1": np.ascontiguousarray(dst, np.uint64).ravel(),
                "batch:2": np.ascontiguousarray(types, np.int32).ravel()}
        out = self._run(f"e(batch).values({fid}).as(p)", feed)
        return self._csr_result(out, "p", np.uint64)

    def get_edge_binary_feature(self, src, dst, types, fid) -> tuple:
        """(offsets[n+1], bytes): per-edge raw byte strings over the
        cluster (reference GetEdgeBinaryFeature)."""
        feed = {"batch:0": np.ascontiguousarray(src, np.uint64).ravel(),
                "batch:1": np.ascontiguousarray(dst, np.uint64).ravel(),
                "batch:2": np.ascontiguousarray(types, np.int32).ravel()}
        out = self._run(f"e(batch).values({fid}).as(p)", feed)
        offs, vals = self._csr_result(out, "p", np.uint8)
        return offs, vals.tobytes()

    def get_node_type(self, ids) -> np.ndarray:
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        out = self._run("v(r).label().as(t)", {"r": ids})
        return out["t:0"].astype(np.int32)

    # -- streaming deltas --------------------------------------------------
    def graph_epoch(self, refresh: bool = False) -> int:
        """Observed graph epoch. Passive by default: the max epoch seen
        on any shard reply (v2 mux frames carry it on every reply;
        without mux the value only moves when delta verbs run).
        refresh=True forces one kGetDelta round trip per shard so
        non-mux clients observe bumps made by OTHER clients."""
        if refresh:
            epoch, _, _ = self.delta_since(self.query.epoch())
            return epoch
        return self.query.epoch()

    def apply_delta(self, node_ids=None, node_types=None,
                    node_weights=None, edge_src=None, edge_dst=None,
                    edge_types=None, edge_weights=None) -> int:
        """Broadcast a batched delta to the cluster: every shard applies
        the rows it hash-owns through the builder machinery and swaps
        in a new snapshot (in-flight queries finish on the old one),
        then this client's routing meta refreshes so weight-
        proportional sampling reflects the post-delta graph. Returns
        the new (max) epoch. Not wrapped in RetryPolicy: the C++
        channel already retries transport failures, and a delta is
        idempotent per shard — re-issuing after a partial failure
        re-applies the same last-write-wins rows."""
        return self.query.apply_delta(
            node_ids=node_ids, node_types=node_types,
            node_weights=node_weights, edge_src=edge_src,
            edge_dst=edge_dst, edge_types=edge_types,
            edge_weights=edge_weights)

    def delta_since(self, from_epoch: int):
        """(epoch, covered, dirty_ids): union of the shards' dirty sets
        for epochs after from_epoch; covered=False → some shard's
        bounded history no longer reaches it (treat all ids dirty)."""
        return self.query.delta_since(int(from_epoch))

    def type_id(self, name_or_id, edge: bool = False) -> int:
        """Cluster clients resolve numeric ids/strings only — type NAME
        metadata lives in the shards' local meta and is not served over
        the wire; resolve names against a local GraphEngine (or extend
        the meta RPC) if needed."""
        if isinstance(name_or_id, (int, np.integer)):
            return int(name_or_id)
        s = str(name_or_id)
        try:
            return int(s)
        except ValueError:
            raise KeyError(
                f"RemoteGraphEngine cannot resolve type NAME {s!r}; "
                "pass the integer type id (names resolve on embedded "
                "engines via GraphEngine.type_id)")

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        _obs.unregister_health(self._obs_name)
        if self.pipeline is not None:
            # drain the worker pool first: pooled calls re-enter _run
            # and must not race the handle teardown below
            self.pipeline.close()
            self.pipeline = None
        # abandoned timed-out attempts still hold exec handles into the
        # query proxy; give them a moment to unblock (their sockets die
        # when the far end/proxy shuts down) and LEAK the proxy rather
        # than free it under a live thread
        with self._health_mu:
            strays, self._strays = self._strays, []
        deadline = time.monotonic() + 5.0
        for th in strays:
            th.join(max(deadline - time.monotonic(), 0.0))
        if any(th.is_alive() for th in strays):
            # leak: a stray thread still uses the handle (under the
            # query lock so a concurrent stats() scrape can't race the
            # zeroing)
            with self.query._mu:
                self.query._h = 0
            return
        self.query.close()
        # proxies/pipelines retired by fleet-growth rebuilds: closed
        # last — no new calls could reach them since the swap, and the
        # stray drain above bounded any in-flight ones
        for p in self._retired_pipelines:
            p.close()
        self._retired_pipelines.clear()
        for q in self._retired_proxies:
            q.close()
        self._retired_proxies.clear()
