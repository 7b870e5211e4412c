"""Parallel host input pipeline: pipelined RPC client + immutable-graph
client cache (copy of euler_tpu/graph/pipeline.py).

PERF.md's decomposition puts the host feeder at the top of every
host-fed path's cost: `RemoteGraphEngine` issued exactly ONE blocking
query at a time, and the feeder iterated serially. This module supplies
the two client-side halves of the fix (the third, the multi-worker
feeder, lives in estimator/prefetch.py):

  * HandlePool / PipelinedClient — a per-engine worker pool (N threads
    over M pooled native Query handles) with a
    ``submit(gql, feed) -> Future`` surface, so multiple queries are in
    flight against the shard cluster at once. Every worker call still
    runs through the OWNING engine's ``_run`` — the same RetryPolicy /
    degrade machinery and ``graph_rpc`` spans as the serial path, just
    against a pooled handle instead of the engine's own.

  * CachedGraphEngine — deterministic reads (``get_full_neighbor``
    rows, ``get_dense_feature`` rows) of a graph SNAPSHOT are served
    from a bounded client cache. The hit/miss partition is one
    vectorized searchsorted/take pass over sorted key arrays — never a
    per-id Python dict loop on the hot path — and only misses go over
    the wire. Sampling verbs are NEVER cached (a cached random draw
    would freeze the sampling distribution), and a result produced
    while the underlying engine degraded (default_id padding) is NEVER
    inserted (the poisoning guard). Streaming deltas turned
    "the graph is frozen" into a CHECKED epoch contract: on an observed
    graph-epoch bump the cache evicts exactly the delta's dirty ids
    (full flush only past ``epoch_dirty_bound`` or a history gap), so
    warm state survives mutation instead of being flushed wholesale.

Everything reports through euler_tpu_torch.obs:
``client_cache_{hits,misses,inserts,evicted_rows}_total{cache=...}`` +
``client_cache_bytes``, ``graph_pipeline_inflight`` /
``graph_pipeline_chunks_total`` and the ``graph_pipeline_chunk_ms``
submit-to-done latency histogram.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.core.lib import EngineError
from euler_tpu_torch.gql import Query, edge_types_str

_CACHE_IDS = itertools.count()
_POOL_IDS = itertools.count()


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[sum(counts)] position-within-row array for ragged rows of the
    given lengths — the shared repeat/cumsum gather idiom."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))


# ---------------------------------------------------------------------------
# pipelined RPC client
# ---------------------------------------------------------------------------

class HandlePool:
    """M pooled native Query handles over the same endpoints.

    Exclusive mode (default): handles check out for exclusive use per
    call (free-list queue; acquire blocks when all M are in flight).
    Concurrent run() on ONE handle is safe (verified under an 8-thread
    stress test, and the serial engine's timed-attempt strays already
    share its handle with retries) — the pool exists for CHANNEL
    parallelism (each handle owns its own connection set to the shards,
    so M handles keep M requests on the wire) and for distinct
    per-handle sampling seeds (concurrent draws must not replay one
    stream).

    Shared mode (``shared=True``, the mux-transport shape): acquire
    never blocks — callers round-robin over the M handles and run
    CONCURRENTLY on them, so N in-flight queries ride M handles (M is
    typically 1) whose mux connections carry them all; the wire fd
    count stops scaling with in-flight depth. Concurrent sampling draws
    on one shared handle stay distinct: every execution takes a fresh
    engine-side nonce, so streams never replay."""

    def __init__(self, endpoints: str, seed: int, mode: str, size: int,
                 shared: bool = False):
        self._q: queue.Queue = queue.Queue()
        self._shared = bool(shared)
        self._cv = threading.Condition()
        self._inflight = 0
        self._rr = 0
        self._handles = []
        for i in range(max(int(size), 1)):
            # distinct per-handle seeds: two concurrent sampling queries
            # on different handles must not replay the same draw stream
            h = Query.remote(endpoints, seed=(seed + i + 1) if seed else 0,
                             mode=mode)
            self._handles.append(h)
            self._q.put(h)
        self.size = len(self._handles)

    def acquire(self) -> Query:
        if self._shared:
            with self._cv:
                self._inflight += 1
                h = self._handles[self._rr % self.size]
                self._rr += 1
                return h
        return self._q.get()

    def release(self, h: Query) -> None:
        if self._shared:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            return
        self._q.put(h)

    def set_ownership(self, spec: str) -> None:
        """Install an ownership-map spec on EVERY pooled handle (the
        engine's map refresh must reach pooled channels too, or chunked
        fan-out would keep routing on the superseded map). Safe against
        concurrent run()s — the native install is atomic per handle."""
        for h in self._handles:
            h.set_ownership(spec)

    def close(self, timeout_s: float = 5.0) -> None:
        """Reclaim and close the handles. A handle parked under a live
        (black-holed) call past the timeout is LEAKED (handle zeroed,
        native memory intentionally not freed) rather than freed under
        a running thread — same policy as RemoteGraphEngine.close."""
        deadline = time.monotonic() + timeout_s
        if self._shared:
            with self._cv:
                while (self._inflight > 0
                       and time.monotonic() < deadline):
                    self._cv.wait(
                        max(min(deadline - time.monotonic(), 0.2), 0.01))
                drained = self._inflight == 0
            for h in self._handles:
                if drained:
                    h.close()
                else:
                    with h._mu:
                        h._h = 0  # leak: live calls still use the handle
            return
        reclaimed = []
        while len(reclaimed) < self.size:
            try:
                reclaimed.append(self._q.get(
                    timeout=max(deadline - time.monotonic(), 0.0)))
            except queue.Empty:
                break
        for h in reclaimed:
            h.close()
        for h in self._handles:
            if h not in reclaimed:
                with h._mu:
                    h._h = 0  # leak: still in use by an abandoned call


class PipelinedClient:
    """N worker threads draining a submit queue against M pooled query
    handles, on behalf of one RemoteGraphEngine. submit() returns a
    concurrent.futures.Future; the worker executes the engine's _run
    (retry/degrade/span machinery included) against a pooled handle."""

    def __init__(self, engine, endpoints: str, seed: int, mode: str,
                 workers: int, handles: Optional[int] = None,
                 shared: bool = False):
        """shared=True: the mux-transport shape — workers run
        CONCURRENTLY on `handles` (default 1) shared query handles, so
        in-flight depth comes from the workers while the wire fd count
        comes from the transport's mux connections, not from handle
        count. False (default): exclusive checkout, one handle per
        in-flight call (the original pool shape)."""
        self._engine = engine
        workers = max(int(workers), 1)
        self._handles = HandlePool(endpoints, seed, mode,
                                   handles or (1 if shared else workers),
                                   shared=shared)
        self._name = f"pipeline{next(_POOL_IDS)}"
        self._exec = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix=f"euler-{self._name}")
        self.workers = workers
        reg = _obs.default_registry()
        lab = {"engine": self._name}
        self._g_inflight = reg.gauge(
            "graph_pipeline_inflight",
            "pipelined graph rpc calls submitted but not completed",
            ("engine",)).labels(**lab)
        self._ctr_chunks = reg.counter(
            "graph_pipeline_chunks_total",
            "pipelined graph rpc submissions", ("engine",)).labels(**lab)
        self._hist_chunk_ms = reg.histogram(
            "graph_pipeline_chunk_ms",
            "submit-to-done latency per pipelined call (queue wait + "
            "rpc + retries)", ("engine",)).labels(**lab)
        self._closed = False

    def submit(self, gql: str, feed=None) -> Future:
        if self._closed:
            raise RuntimeError("PipelinedClient is closed")
        self._ctr_chunks.inc()
        self._g_inflight.inc()
        t_submit = time.monotonic()

        def call():
            try:
                h = self._handles.acquire()
                try:
                    return self._engine._run(gql, feed, query=h)
                finally:
                    self._handles.release(h)
            finally:
                self._g_inflight.dec()
                self._hist_chunk_ms.observe(
                    (time.monotonic() - t_submit) * 1000.0)

        return self._exec.submit(call)

    def set_ownership(self, spec: str) -> None:
        """Forward an ownership-map install to the pooled handles."""
        self._handles.set_ownership(spec)

    def close(self, timeout_s: float = 5.0) -> None:
        """Bounded shutdown mirroring the engine's stray policy: a
        worker parked on a black-holed socket must not hang close()
        forever — past the timeout its handle is leaked (by
        HandlePool.close) rather than freed under a live thread."""
        if self._closed:
            return
        self._closed = True
        deadline = time.monotonic() + timeout_s
        self._exec.shutdown(wait=False, cancel_futures=True)
        for t in list(getattr(self._exec, "_threads", ())):
            t.join(max(deadline - time.monotonic(), 0.0))
        self._handles.close(max(deadline - time.monotonic(), 0.1))


# ---------------------------------------------------------------------------
# in-flight request dedup
# ---------------------------------------------------------------------------

def deterministic_gql(gql: str) -> bool:
    """True when the query reads immutable graph state and two identical
    executions return identical bytes — the coalescing precondition.
    Every sampling verb starts with 'sample' (sampleN/sampleE/sampleNB/
    sampleLNB/sampleNWithTypes/sampleGL), so one marker refuses them
    all; udf() is excluded too (registered UDFs are REQUIRED pure for
    the result cache, but a stateful one would silently corrupt
    coalesced callers — refusing costs one wire call)."""
    return "sample" not in gql and "udf(" not in gql


class InflightDedup:
    """Coalesce concurrent IDENTICAL deterministic queries onto one wire
    call (e.g. overlapping feeder workers fetching the same feature
    rows). The first caller (leader) issues the call; callers that
    arrive with the same (gql, feed bytes) key while it is IN FLIGHT
    wait on the leader's future and receive byte-identical COPIES of
    its result (copies: callers may mutate returned arrays). The key
    holds the full feed bytes — no hash-collision coalescing. Entries
    leave the table the moment the leader finishes, so this never acts
    as a result cache (CachedGraphEngine is that, above this layer).
    Sampling verbs bypass entirely (see deterministic_gql): coalescing
    two draws would correlate their randomness.

    Counted on the obs registry: rpc_dedup_hits_total{engine=} (calls
    served from a leader's flight) / rpc_dedup_issued_total (leader
    flights that had at least the leader)."""

    def __init__(self, name: str):
        self._mu = threading.Lock()
        self._inflight: Dict[tuple, list] = {}  # key -> [Future, followers]
        reg = _obs.default_registry()
        lab = {"engine": name}
        self._ctr_hits = reg.counter(
            "rpc_dedup_hits_total",
            "calls coalesced onto an identical in-flight query",
            ("engine",)).labels(**lab)
        self._ctr_issued = reg.counter(
            "rpc_dedup_issued_total",
            "deduplicable queries that actually went to the wire",
            ("engine",)).labels(**lab)

    @staticmethod
    def _key(gql: str, feed) -> tuple:
        if not feed:
            return (gql,)
        items = []
        for k in sorted(feed):
            a = np.ascontiguousarray(feed[k])
            items.append((k, a.dtype.str, a.shape, a.tobytes()))
        return (gql, tuple(items))

    @staticmethod
    def _copy_result(out):
        if isinstance(out, dict):
            return {k: (np.array(v, copy=True)
                        if isinstance(v, np.ndarray) else v)
                    for k, v in out.items()}
        return out

    def run(self, gql: str, feed, fn):
        """fn() under dedup: leader executes, followers wait + copy."""
        if not deterministic_gql(gql):
            return fn()
        key = self._key(gql, feed)
        with self._mu:
            entry = self._inflight.get(key)
            leader = entry is None
            if leader:
                entry = [Future(), 0]
                self._inflight[key] = entry
            else:
                entry[1] += 1
        fut = entry[0]
        if not leader:
            self._ctr_hits.inc()
            return self._copy_result(fut.result())
        self._ctr_issued.inc()
        try:
            out = fn()
        except BaseException as e:
            with self._mu:
                self._inflight.pop(key, None)
            fut.set_exception(e)
            raise
        # drop the entry BEFORE completing the future: a caller arriving
        # after completion must issue its own call (in-flight dedup, not
        # a cache) and a waiter that joined in time still gets the result
        with self._mu:
            self._inflight.pop(key, None)
            followers = entry[1]
        fut.set_result(out)
        # followers copy from the future's pristine arrays AFTER this
        # return — the leader's caller may mutate its result, so when
        # anyone coalesced, hand the leader its own copy too
        return self._copy_result(out) if followers else out


# ---------------------------------------------------------------------------
# immutable-graph client cache
# ---------------------------------------------------------------------------

class _DenseStore:
    """Sorted-key store of fixed-width float32 rows (dense features).
    All operations are whole-array numpy passes."""

    __slots__ = ("keys", "vals", "gen", "width", "splits")

    def __init__(self):
        self.keys = np.zeros(0, dtype=np.uint64)
        self.vals = np.zeros((0, 0), dtype=np.float32)
        self.gen = np.zeros(0, dtype=np.int64)
        self.width = -1              # columns; -1 until first insert
        self.splits: Optional[Tuple[int, ...]] = None  # per-fid widths

    def lookup(self, ids: np.ndarray):
        """(hit_mask, store_rows) — store_rows valid where hit_mask."""
        if self.keys.size == 0:
            return np.zeros(ids.size, dtype=bool), None
        pos = np.searchsorted(self.keys, ids)
        pos = np.minimum(pos, self.keys.size - 1)
        hit = self.keys[pos] == ids
        return hit, pos

    def insert(self, ids: np.ndarray, rows: np.ndarray, gen: int) -> None:
        """Merge new (unique, absent) ids + rows, keeping keys sorted."""
        if self.width < 0:
            self.width = int(rows.shape[1])
        keys = np.concatenate([self.keys, ids])
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.vals = np.concatenate(
            [self.vals.reshape(-1, self.width),
             rows.astype(np.float32, copy=False)])[order]
        self.gen = np.concatenate(
            [self.gen, np.full(ids.size, gen, np.int64)])[order]

    def touch(self, rows: np.ndarray, gen: int) -> None:
        self.gen[rows] = gen

    def drop_oldest_half(self) -> int:
        if self.keys.size == 0:
            return 0
        cut = np.median(self.gen)
        keep = self.gen > cut
        if keep.all():                  # all gens equal: drop everything
            keep = np.zeros(self.keys.size, dtype=bool)
        dropped = int((~keep).sum())
        self.keys = self.keys[keep]
        self.vals = self.vals[keep]
        self.gen = self.gen[keep]
        return dropped

    def drop_ids(self, ids_sorted: np.ndarray) -> int:
        """Surgical epoch invalidation: evict exactly the rows whose key
        is in the (sorted unique) dirty set; every other row is
        retained warm. One searchsorted pass — O(n log d)."""
        if self.keys.size == 0 or ids_sorted.size == 0:
            return 0
        pos = np.searchsorted(ids_sorted, self.keys)
        pos = np.minimum(pos, ids_sorted.size - 1)
        keep = ids_sorted[pos] != self.keys
        dropped = int((~keep).sum())
        if dropped:
            self.keys = self.keys[keep]
            self.vals = self.vals[keep]
            self.gen = self.gen[keep]
        return dropped

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes + self.vals.nbytes + self.gen.nbytes)

    @property
    def entries(self) -> int:
        return int(self.keys.size)


class _RaggedStore:
    """Sorted-key CSR store of ragged rows (full neighbor lists):
    keys[n] sorted, off[n+1], parallel value columns of length off[-1]
    (nbr uint64, w float32, t int32)."""

    __slots__ = ("keys", "off", "cols", "gen")

    def __init__(self):
        self.keys = np.zeros(0, dtype=np.uint64)
        self.off = np.zeros(1, dtype=np.int64)
        self.cols: Tuple[np.ndarray, ...] = (
            np.zeros(0, np.uint64), np.zeros(0, np.float32),
            np.zeros(0, np.int32))
        self.gen = np.zeros(0, dtype=np.int64)

    def lookup(self, ids: np.ndarray):
        if self.keys.size == 0:
            return np.zeros(ids.size, dtype=bool), None
        pos = np.searchsorted(self.keys, ids)
        pos = np.minimum(pos, self.keys.size - 1)
        hit = self.keys[pos] == ids
        return hit, pos

    def gather(self, rows: np.ndarray):
        """(counts, col_values...) for the given store rows, row-major —
        one repeat/take pass, no per-row loop."""
        counts = self.off[rows + 1] - self.off[rows]
        src = np.repeat(self.off[rows], counts) + _ranges(counts)
        return (counts,) + tuple(c[src] for c in self.cols)

    def insert(self, ids: np.ndarray, counts: np.ndarray, cols, gen: int):
        """Merge new (unique, absent) CSR rows; rebuilds the packed
        arrays with one argsort + gather pass."""
        old_counts = np.diff(self.off)
        all_keys = np.concatenate([self.keys, ids])
        all_counts = np.concatenate([old_counts, counts])
        starts = np.concatenate(
            [self.off[:-1], self.off[-1] + np.cumsum(counts) - counts])
        order = np.argsort(all_keys, kind="stable")
        cnt_o = all_counts[order]
        src = np.repeat(starts[order], cnt_o) + _ranges(cnt_o)
        flat = tuple(np.concatenate([old, new])[src]
                     for old, new in zip(self.cols, cols))
        self.keys = all_keys[order]
        self.off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(cnt_o, dtype=np.int64)])
        self.cols = flat
        self.gen = np.concatenate(
            [self.gen, np.full(ids.size, gen, np.int64)])[order]

    def touch(self, rows: np.ndarray, gen: int) -> None:
        self.gen[rows] = gen

    def drop_oldest_half(self) -> int:
        if self.keys.size == 0:
            return 0
        cut = np.median(self.gen)
        keep = self.gen > cut
        if keep.all():
            keep = np.zeros(self.keys.size, dtype=bool)
        return self._drop_mask(keep)

    def drop_ids(self, ids_sorted: np.ndarray) -> int:
        """Surgical epoch invalidation (see _DenseStore.drop_ids)."""
        if self.keys.size == 0 or ids_sorted.size == 0:
            return 0
        pos = np.searchsorted(ids_sorted, self.keys)
        pos = np.minimum(pos, ids_sorted.size - 1)
        keep = ids_sorted[pos] != self.keys
        if keep.all():
            return 0
        return self._drop_mask(keep)

    def _drop_mask(self, keep: np.ndarray) -> int:
        dropped = int((~keep).sum())
        rows = np.flatnonzero(keep)
        counts, *cols = self.gather(rows)
        self.keys = self.keys[keep]
        self.off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
        self.cols = tuple(cols)
        self.gen = self.gen[keep]
        return dropped

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes + self.off.nbytes + self.gen.nbytes
                   + sum(c.nbytes for c in self.cols))

    @property
    def entries(self) -> int:
        return int(self.keys.size)


class CachedGraphEngine:
    """Bounded, thread-safe client cache over an engine-shaped object.

    Serves exactly the DETERMINISTIC reads of an immutable graph —
    ``get_full_neighbor`` (per edge_types/sorted/in_edges variant) and
    ``get_dense_feature`` (per fids/dims spec) — byte-identically to the
    wrapped engine; everything else (all sampling verbs, sparse/binary
    getters, lifecycle) passes straight through. Keyed lookups are one
    searchsorted/take pass over sorted uint64 key arrays; only misses
    (deduplicated) go over the wire.

    Poisoning guard: a fetch during which the underlying engine's
    ``degraded`` counter moved is NOT inserted — default_id padding must
    never become a permanent cache row. (Feature/neighbor getters never
    degrade today; the guard makes that a checked invariant rather than
    an assumption about remote.py's current shape.)

    Eviction: ``budget_bytes`` bounds the packed arrays; over budget the
    largest store drops its least-recently-used half (generation
    median) until under. stats()/health() are views over the
    client_cache_* obs registry counters by construction.
    """

    def __init__(self, engine, budget_bytes: int = 64 << 20,
                 name: Optional[str] = None,
                 epoch_dirty_bound: int = 262_144):
        """epoch_dirty_bound: max dirty-id set a graph-epoch bump is
        invalidated SURGICALLY from (evict only keys in the delta's
        dirty set); a bigger delta — or a history gap (covered=False) —
        falls back to the documented full flush. Counted either way:
        cache_epoch_{evicted,retained}_total / cache_epoch_flushes_total."""
        self._engine = engine
        self._budget = int(budget_bytes)
        self._mu = threading.RLock()
        self._gen = 0
        self._dense: Dict[tuple, _DenseStore] = {}
        self._ragged: Dict[tuple, _RaggedStore] = {}
        self._obs_name = name or f"cache{next(_CACHE_IDS)}"
        reg = _obs.default_registry()
        lab = {"cache": self._obs_name}
        self._ctr = {
            k: reg.counter(f"client_cache_{k}_total", h,
                           ("cache",)).labels(**lab)
            for k, h in (
                ("hits", "ids served from the client graph cache"),
                ("misses", "ids fetched over the wire"),
                ("inserts", "rows inserted into the client graph cache"),
                ("evicted_rows", "rows evicted under the byte budget"),
                ("poison_skips",
                 "fetches not cached because the engine degraded"),
            )}
        # streaming-delta invalidation accounting: evicted = rows whose
        # id was dirty, retained = warm rows that SURVIVED a bump (the
        # state a naive full flush would have destroyed), flushes =
        # bumps that fell back to a full flush (overflow / history gap)
        self._ctr_epoch = {
            k: reg.counter(f"cache_epoch_{k}_total", h,
                           ("cache",)).labels(**lab)
            for k, h in (
                ("evicted", "cache rows evicted by graph epoch bumps"),
                ("retained", "warm cache rows retained across epoch bumps"),
                ("flushes", "epoch bumps answered with a full flush"),
            )}
        self._g_bytes = reg.gauge(
            "client_cache_bytes", "packed client-cache array bytes",
            ("cache",)).labels(**lab)
        self._g_epoch = reg.gauge(
            "graph_epoch", "last graph epoch this cache reconciled to",
            ("cache",)).labels(**lab)
        self._dirty_bound = int(epoch_dirty_bound)
        # last epoch this cache reconciled to; None until the engine
        # exposes one (plain engine-shaped test doubles never do)
        self._observed_epoch: Optional[int] = None
        epoch_fn = getattr(engine, "graph_epoch", None)
        if callable(epoch_fn):
            try:
                self._observed_epoch = int(epoch_fn())
                self._g_epoch.set(self._observed_epoch)
            except (EngineError, OSError, AttributeError):
                # AttributeError: a delegating wrapper (ChaosGraphEngine)
                # always EXPOSES graph_epoch but raises when its inner
                # engine lacks it — that composition must keep working
                self._observed_epoch = None
        _obs.register_health(self._obs_name, self.cache_stats)

    # -- passthrough -------------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._engine, name)

    # -- introspection -----------------------------------------------------
    def cache_stats(self) -> dict:
        """{hits, misses, inserts, evicted_rows, poison_skips, bytes,
        entries, hit_rate} — a VIEW over the client_cache_* registry
        children (the same numbers a /metrics scrape reports)."""
        out = {k: int(c.value) for k, c in self._ctr.items()}
        out["bytes"] = int(self._g_bytes.value)
        with self._mu:
            out["entries"] = sum(
                s.entries for s in (*self._dense.values(),
                                    *self._ragged.values()))
            out["graph_epoch"] = self._observed_epoch
        for k, c in self._ctr_epoch.items():
            out[f"epoch_{k}"] = int(c.value)
        total = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / total if total else 0.0
        return out

    def health(self) -> dict:
        h = getattr(self._engine, "health", None)
        out = h() if callable(h) else {}
        out["cache"] = self.cache_stats()
        return out

    def clear_cache(self) -> None:
        with self._mu:
            self._dense.clear()
            self._ragged.clear()
            self._refresh_bytes()

    # -- elastic fleet (explicit delegation) -------------------------------
    # Ownership routing lives in the wrapped engine; the cache stays
    # VALID across map flips (ownership moves requests, not data — the
    # epoch-invalidation machinery below owns data coherence). Explicit
    # so an engine lacking the verbs raises its own AttributeError.
    def refresh_ownership(self, force: bool = False) -> int:
        return self._engine.refresh_ownership(force=force)

    def ownership_epoch(self) -> int:
        return self._engine.ownership_epoch()

    def shard_traffic(self):
        return self._engine.shard_traffic()


    # -- streaming-delta epoch coherence -----------------------------------
    def graph_epoch(self, *args, **kwargs) -> int:
        return self._engine.graph_epoch(*args, **kwargs)

    def delta_since(self, from_epoch: int):
        return self._engine.delta_since(from_epoch)

    def apply_delta(self, **delta) -> int:
        """Apply a delta through the wrapped engine, then invalidate
        THIS cache surgically from the delta itself — the dirty set is
        known locally (nodes ∪ edge endpoints), so the issuing client
        pays zero extra RPCs to stay coherent. If the engine's epoch
        jumped FURTHER than our own delta (another client applied
        in between), the local dirty set does not cover the gap —
        reconcile through the engine's history instead of silently
        skipping the intermediate epochs' dirty ids."""
        from euler_tpu_torch.graph.api import delta_dirty_ids

        epoch = self._engine.apply_delta(**delta)
        dirty = delta_dirty_ids(**delta)
        gap = (self._observed_epoch is None
               or epoch != self._observed_epoch + 1)
        if gap:
            try:
                from_e = self._observed_epoch or 0
                e2, covered, hist = self._engine.delta_since(from_e)
                dirty = hist if covered else None
                epoch = max(epoch, e2)
            except (EngineError, OSError):
                dirty = None  # can't prove coverage → flush
        with self._mu:
            self._apply_dirty(dirty)
            self._observed_epoch = epoch
            self._g_epoch.set(epoch)
        return epoch

    def maybe_invalidate(self) -> None:
        """Reconcile the cache with the engine's current epoch. Called
        on every cached read (one native epoch poll, ~µs) and safe to
        call explicitly after an out-of-band delta. On a bump: evict
        only the dirty ids when the engine's history covers the gap and
        the set is under epoch_dirty_bound; otherwise the documented
        full-flush fallback. No epoch surface on the engine → no-op
        (the immutable-graph contract)."""
        if self._observed_epoch is None:
            return
        epoch_fn = getattr(self._engine, "graph_epoch", None)
        if not callable(epoch_fn):
            return
        try:
            cur = int(epoch_fn())
        except (EngineError, OSError, AttributeError):
            return
        if cur < self._observed_epoch:
            # epoch REGRESSION: the engine (a restarted shard) lost
            # deltas we already reconciled to — nothing can prove which
            # warm rows still match, so flush and re-anchor
            with self._mu:
                self._apply_dirty(None)
                self._observed_epoch = cur
                self._g_epoch.set(cur)
            return
        if cur == self._observed_epoch:
            return
        try:
            epoch, covered, dirty = self._engine.delta_since(
                self._observed_epoch)
        except (EngineError, OSError, AttributeError):
            return  # transient failure: retry at the next read
        with self._mu:
            if not covered:
                dirty = None  # history gap → everything is dirty
            self._apply_dirty(dirty)
            self._observed_epoch = max(epoch, cur)
            self._g_epoch.set(self._observed_epoch)

    def _apply_dirty(self, dirty: Optional[np.ndarray]) -> None:
        """Under self._mu: evict dirty ids (surgical) or flush. dirty
        None → flush; oversized dirty set → flush (documented bound)."""
        before = sum(s.entries for s in (*self._dense.values(),
                                         *self._ragged.values()))
        if dirty is not None and dirty.size <= self._dirty_bound:
            ids = np.asarray(dirty, dtype=np.uint64).ravel()
            evicted = 0
            for store in (*self._dense.values(), *self._ragged.values()):
                evicted += store.drop_ids(ids)
            self._ctr_epoch["evicted"].inc(evicted)
            self._ctr_epoch["retained"].inc(before - evicted)
        else:
            self._dense.clear()
            self._ragged.clear()
            self._ctr_epoch["evicted"].inc(before)
            self._ctr_epoch["flushes"].inc()
        self._refresh_bytes()

    # -- internals ---------------------------------------------------------
    def _degraded_count(self) -> int:
        ctr = getattr(self._engine, "_ctr", None)
        if isinstance(ctr, dict) and "degraded" in ctr:
            return int(ctr["degraded"].value)
        return 0

    def _refresh_bytes(self) -> int:
        b = sum(s.nbytes for s in (*self._dense.values(),
                                   *self._ragged.values()))
        self._g_bytes.set(b)
        return b

    def _maybe_evict(self) -> None:
        while self._refresh_bytes() > self._budget:
            stores = [s for s in (*self._dense.values(),
                                  *self._ragged.values()) if s.entries]
            if not stores:
                break
            victim = max(stores, key=lambda s: s.nbytes)
            self._ctr["evicted_rows"].inc(victim.drop_oldest_half())

    def _next_gen(self) -> int:
        self._gen += 1
        return self._gen

    # -- cached reads ------------------------------------------------------
    def get_dense_feature(self, ids, fids, dims=None):
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        single = not isinstance(fids, (list, tuple, np.ndarray))
        names = tuple([fids] if single else list(fids))
        dims_t = None if dims is None else tuple(
            [dims] if single else list(dims))
        key = ("dense", names, dims_t)
        n = ids.size
        if n == 0:
            return self._engine.get_dense_feature(ids, fids, dims)
        self.maybe_invalidate()
        with self._mu:
            store = self._dense.setdefault(key, _DenseStore())
            hit, pos = store.lookup(ids)
            n_hit = int(hit.sum())
            gen = self._next_gen()
            if n_hit:
                hit_rows = pos[hit]
                store.touch(hit_rows, gen)
                hit_vals = store.vals[hit_rows]
            splits = store.splits
            width = store.width
            epoch0 = self._observed_epoch
        self._ctr["hits"].inc(n_hit)
        self._ctr["misses"].inc(n - n_hit)
        if n_hit == n:
            out = np.ascontiguousarray(hit_vals)
            return self._split_dense(out, splits, single)
        miss_ids = ids[~hit]
        uniq, inv = np.unique(miss_ids, return_inverse=True)
        d0 = self._degraded_count()
        fetched = self._engine.get_dense_feature(uniq, fids, dims)
        poisoned = self._degraded_count() > d0
        parts = [fetched] if single else list(fetched)
        f_splits = tuple(int(p.shape[1]) for p in parts)
        packed = parts[0] if len(parts) == 1 else np.concatenate(
            parts, axis=1)
        if width >= 0 and packed.shape[1] != width:
            # inferred width changed (graph_partition ragged rows + no
            # explicit dims): the cached rows and this batch disagree on
            # the padded shape — drop the store and answer the whole
            # request fresh so cache-on stays byte-identical to
            # cache-off for THIS call
            with self._mu:
                self._dense.pop(key, None)
                self._refresh_bytes()
            return self._engine.get_dense_feature(ids, fids, dims)
        if not poisoned:
            with self._mu:
                # re-check under the lock: a concurrent caller may have
                # fetched+inserted the same misses while we were on the
                # wire — the stores' insert requires ABSENT keys, and
                # duplicates would bloat bytes/entries for nothing.
                # Epoch guard: a delta observed while we were on the
                # wire means these rows may be PRE-delta — serving them
                # to this caller is fine (the bump was not yet observed
                # at fetch time), caching them would be permanent
                # staleness.
                hit2, _ = store.lookup(uniq)
                fresh = ~hit2
                if fresh.any() and self._observed_epoch == epoch0:
                    store.splits = store.splits or f_splits
                    store.insert(uniq[fresh], packed[fresh], gen)
                    self._ctr["inserts"].inc(int(fresh.sum()))
                    self._maybe_evict()
        else:
            self._ctr["poison_skips"].inc()
        out = np.empty((n, packed.shape[1]), dtype=np.float32)
        if n_hit:
            out[hit] = hit_vals
        out[~hit] = packed[inv]
        return self._split_dense(out, splits or f_splits, single)

    @staticmethod
    def _split_dense(out: np.ndarray, splits, single: bool):
        if single:
            return out
        edges = np.cumsum((0,) + tuple(splits))
        return [np.ascontiguousarray(out[:, a:b])
                for a, b in zip(edges[:-1], edges[1:])]

    def get_full_neighbor(self, ids, edge_types=None,
                          sorted_by_id: bool = False,
                          in_edges: bool = False):
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        key = ("nbr", edge_types_str(edge_types), bool(sorted_by_id),
               bool(in_edges))
        n = ids.size
        self.maybe_invalidate()
        with self._mu:
            store = self._ragged.setdefault(key, _RaggedStore())
            hit, pos = store.lookup(ids)
            n_hit = int(hit.sum())
            gen = self._next_gen()
            if n_hit:
                hit_rows = pos[hit]
                store.touch(hit_rows, gen)
                h_cnt, h_nbr, h_w, h_t = store.gather(hit_rows)
            epoch0 = self._observed_epoch
        self._ctr["hits"].inc(n_hit)
        self._ctr["misses"].inc(n - n_hit)
        counts = np.zeros(n, dtype=np.int64)
        if n_hit:
            counts[hit] = h_cnt
        if n_hit < n:
            miss_ids = ids[~hit]
            uniq, inv = np.unique(miss_ids, return_inverse=True)
            d0 = self._degraded_count()
            off_u, nbr_u, w_u, t_u = self._engine.get_full_neighbor(
                uniq, edge_types=edge_types, sorted_by_id=sorted_by_id,
                in_edges=in_edges)
            poisoned = self._degraded_count() > d0
            off_u = off_u.astype(np.int64)
            cnt_u = np.diff(off_u)
            if not poisoned:
                with self._mu:
                    # same still-absent re-check + epoch guard as the
                    # dense path (a mid-fetch delta orphans this batch)
                    hit2, _ = store.lookup(uniq)
                    rows = np.flatnonzero(~hit2)
                    if rows.size and self._observed_epoch != epoch0:
                        rows = rows[:0]
                    if rows.size:
                        cnt_f = cnt_u[rows]
                        src = (np.repeat(off_u[:-1][rows], cnt_f)
                               + _ranges(cnt_f))
                        store.insert(uniq[rows], cnt_f,
                                     (nbr_u[src], w_u[src], t_u[src]),
                                     gen)
                        self._ctr["inserts"].inc(rows.size)
                        self._maybe_evict()
            else:
                self._ctr["poison_skips"].inc()
            m_cnt = cnt_u[inv]
            m_src = np.repeat(off_u[inv], m_cnt) + _ranges(m_cnt)
            counts[~hit] = m_cnt
        out_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts, dtype=np.int64)])
        total = int(out_off[-1])
        out_nbr = np.empty(total, dtype=np.uint64)
        out_w = np.empty(total, dtype=np.float32)
        out_t = np.empty(total, dtype=np.int32)
        if n_hit:
            dst = np.repeat(out_off[:-1][hit], h_cnt) + _ranges(h_cnt)
            out_nbr[dst], out_w[dst], out_t[dst] = h_nbr, h_w, h_t
        if n_hit < n:
            dst = np.repeat(out_off[:-1][~hit], m_cnt) + _ranges(m_cnt)
            out_nbr[dst] = nbr_u[m_src]
            out_w[dst] = w_u[m_src]
            out_t[dst] = t_u[m_src]
        return out_off.astype(np.uint64), out_nbr, out_w, out_t

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        _obs.unregister_health(self._obs_name)
        close = getattr(self._engine, "close", None)
        if callable(close):
            close()
