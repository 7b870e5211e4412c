"""GQL query interface: gremlin-style strings against the graph engine
(copy of euler_tpu/gql.py over the port's own engine build, core/lib.py:
every Query, shard and registry here lives in the port's library, never
the reference's; the two speak the same wire, rpc.cc).

Capability parity with the reference's euler.Query/QueryProxy surface
(euler/client/query.h:33, query_proxy.h:39 — SURVEY.md §2.1) and the
`initialize_graph` remote/local mode switch (tf_euler/python/euler_ops/
base.py:37). A `Query` object targets either an embedded in-process graph
(local mode: compile → fuse → execute on the host thread pool) or a set of
remote graph shards (distribute mode: compile → split/REMOTE/merge over
framed-TCP RPC), transparently to the caller::

    q = Query.local(engine, index_spec="price:range_index")
    out = q.run("sampleN(0, 64).has(price gt 3).values(f).as(feat)",
                )
    ids = out["feat:1"]

    server = start_service(data_dir, shard_idx=0, shard_num=2, port=9190)
    q = Query.remote("hosts:127.0.0.1:9190,127.0.0.1:9191")

Supported chain calls (see euler_tpu/core/cc/gql.h for the grammar):
v, e, gl, sampleN, sampleE, sampleNWithTypes, sampleGL, graphNodes,
sampleNB, sampleLNB, getNB/outV, getRNB/inV, getSortedNB, getTopKNB,
values, udf, label, has, hasLabel, hasKey, hasId, orderBy, limit, as.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
from typing import Dict, Optional

import numpy as np

from euler_tpu_torch.core import lib as _libmod
from euler_tpu_torch.core.lib import EngineError, check

__all__ = ["Query", "GraphService", "start_service", "compile_debug",
           "register_udf", "udf_cache_stats", "udf_cache_clear",
           "udf_cache_set_capacity", "edge_types_str", "wal_stats",
           "push_ownership", "server_trace_hist", "server_trace_spans",
           "server_trace_chrome", "store_stats", "cold_read_quantile"]


def edge_types_str(edge_types) -> str:
    """GQL edge-type argument convention: None/empty → "*" (all types),
    else colon-joined ids — the single definition shared by the remote
    client and the conditioned ops facade."""
    if edge_types is None:
        return "*"
    return ":".join(str(int(t)) for t in edge_types) or "*"

def _note_unexpected(site: str, exc: BaseException) -> None:
    """Count an exception that a best-effort site (a __del__, the UDF
    trampoline) must swallow but did NOT expect — on the obs registry
    (gql_unexpected_errors_total{site=}), so it is visible on /metrics
    instead of vanishing. Never raises: these sites run during GC and
    interpreter teardown, where even the import can fail."""
    try:
        from euler_tpu_torch import obs

        obs.default_registry().counter(
            "gql_unexpected_errors_total",
            "unexpected exceptions swallowed at best-effort gql sites",
            ("site",)).labels(site=site).inc()
    except Exception:
        pass  # interpreter teardown: nothing left to report into


_DTYPES = {
    0: np.uint64,
    1: np.int64,
    2: np.int32,
    3: np.float32,
    4: np.uint8,
}
_DTYPE_CODES = {
    np.dtype(np.uint64): 0,
    np.dtype(np.int64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.float32): 3,
    np.dtype(np.uint8): 4,
}


class Query:
    """A query proxy bound to a local engine or a remote shard set."""

    def __init__(self, lib, handle: int, mode: str = "local"):
        self._lib = lib
        self._h = handle
        self._mode = mode  # "local" | "distribute" — explain() renders it
        # guards _h for stats()/close(): a /metrics scrape thread polls
        # stats() via the bind_obs collector while the owner may be
        # close()ing — without the lock that is a use-after-free on the
        # native handle. run() stays lock-free (owner-thread hot path).
        self._mu = threading.Lock()

    @classmethod
    def local(cls, engine, index_spec: str = "", seed: int = 0) -> "Query":
        """Embedded mode over a GraphEngine
        (euler_tpu_torch.graph.GraphEngine)."""
        lib = _libmod.load()
        h = lib.etq_new_local(engine.h, index_spec.encode(), seed)
        if h == 0:
            raise EngineError(lib.etg_last_error().decode())
        return cls(lib, h)

    @classmethod
    def remote(cls, endpoints: str, seed: int = 0,
               mode: str = "distribute") -> "Query":
        """Distribute mode. endpoints: "hosts:h:p,h:p" or "dir:/registry"."""
        lib = _libmod.load()
        h = lib.etq_new_remote(endpoints.encode(), seed, mode.encode())
        if h == 0:
            raise EngineError(lib.etg_last_error().decode())
        return cls(lib, h, mode=mode)

    def run(self, gremlin: str,
            inputs: Optional[Dict[str, np.ndarray]] = None,
            deadline_ms: Optional[float] = None,
            trace: Optional[tuple] = None
            ) -> Dict[str, np.ndarray]:
        """Execute a chain; returns alias outputs ("name:i") + terminals.

        deadline_ms: remaining per-call budget to PROPAGATE to remote
        shards (v2 frames carry it; a shard sheds a request whose
        budget expired before dispatch — counted deadline_shed, never a
        silent partial). Does not bound the call locally; local proxies
        and v1 peers ignore it.

        trace: (trace_id, parent_span_id) wire trace context to stamp
        into every REMOTE sub-call's v2 frame (hello-negotiated
        kFeatTrace) — the shard records its queue/decode/execute/
        serialize breakdown under it, so a merged chrome trace stitches
        server time beneath the client span. None (or a 0 trace id)
        stamps nothing: the wire stays byte-identical."""
        lib = self._lib
        eh = lib.etq_exec_new(self._h)
        if eh == 0:
            raise EngineError(lib.etg_last_error().decode())
        if deadline_ms is not None and deadline_ms > 0:
            # per-thread handoff, consumed by the native run below; the
            # finally clears it so a failed run can't leak the budget
            # into the next deadline-less call on this thread
            lib.etg_set_call_deadline_ms(float(deadline_ms))
        traced = trace is not None and int(trace[0]) != 0
        if traced:
            lib.etg_set_call_trace(int(trace[0]) & (2 ** 64 - 1),
                                   int(trace[1]) & (2 ** 64 - 1))
        try:
            for name, arr in (inputs or {}).items():
                a = np.ascontiguousarray(arr)
                if a.dtype not in _DTYPE_CODES:
                    if np.issubdtype(a.dtype, np.integer):
                        a = a.astype(np.int64)
                    else:
                        a = a.astype(np.float32)
                dims = np.array(a.shape or (1,), dtype=np.int64)
                check(lib, lib.etq_exec_add_input(
                    eh, name.encode(), _DTYPE_CODES[a.dtype], dims.size,
                    dims.ctypes.data_as(_libmod.c_i64p),
                    a.ctypes.data_as(ctypes.c_void_p)))
            check(lib, lib.etq_exec_run(eh, gremlin.encode()))
            out: Dict[str, np.ndarray] = {}
            n = lib.etq_exec_output_count(eh)
            for i in range(n):
                name = lib.etq_exec_output_name(eh, i).decode()
                dt = ctypes.c_int32()
                rank = ctypes.c_int32()
                numel = ctypes.c_int64()
                check(lib, lib.etq_exec_output_info(
                    eh, i, ctypes.byref(dt), ctypes.byref(rank),
                    ctypes.byref(numel)))
                dims = np.zeros(max(rank.value, 1), dtype=np.int64)
                check(lib, lib.etq_exec_output_dims(
                    eh, i, dims.ctypes.data_as(_libmod.c_i64p)))
                dtype = _DTYPES[dt.value]
                arr = np.empty(int(numel.value), dtype=dtype)
                ptr = lib.etq_exec_output_data(eh, i)
                if arr.size and ptr:
                    ctypes.memmove(arr.ctypes.data, ptr,
                                   arr.size * arr.itemsize)
                out[name] = arr.reshape(dims[:rank.value]
                                        if rank.value else ())
            return out
        finally:
            if deadline_ms is not None and deadline_ms > 0:
                lib.etg_set_call_deadline_ms(0.0)
            if traced:
                lib.etg_set_call_trace(0, 0)
            lib.etq_exec_free(eh)

    # -- streaming deltas --------------------------------------------------
    def epoch(self) -> int:
        """Observed graph epoch: exact for local proxies; for remote
        proxies the max epoch seen on any shard reply (v2 mux frames
        piggyback it — call delta_since for an active refresh)."""
        e = self._lib.etq_epoch(self._h)
        if e < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        return int(e)

    def apply_delta(self, node_ids=None, node_types=None,
                    node_weights=None, edge_src=None, edge_dst=None,
                    edge_types=None, edge_weights=None) -> int:
        """Batched delta through this proxy: local mode swaps the bound
        graph handle's snapshot; distribute mode broadcasts the delta
        to every shard (each applies the rows it hash-owns and bumps
        its epoch). Returns the new epoch."""
        from euler_tpu_torch.graph.api import _delta_arrays

        nid, nt, nw, es, ed, et, ew = _delta_arrays(
            node_ids, node_types, node_weights, edge_src, edge_dst,
            edge_types, edge_weights)
        out_epoch = ctypes.c_int64()
        check(self._lib, self._lib.etq_apply_delta(
            self._h, nid.size,
            nid.ctypes.data_as(_libmod.c_u64p),
            nt.ctypes.data_as(_libmod.c_i32p),
            nw.ctypes.data_as(_libmod.c_f32p), es.size,
            es.ctypes.data_as(_libmod.c_u64p),
            ed.ctypes.data_as(_libmod.c_u64p),
            et.ctypes.data_as(_libmod.c_i32p),
            ew.ctypes.data_as(_libmod.c_f32p), ctypes.byref(out_epoch)))
        return int(out_epoch.value)

    # -- elastic fleet (ownership maps; remote proxies) --------------------
    def set_ownership(self, spec: str) -> None:
        """Install the epoch-versioned ownership map this client routes
        with (registry-published spec, e.g. "e3-P4-0.1.2.2+3"). Splits
        then place ids by the map's owner lists (p2c over replicated
        partitions' owners) and every request is stamped with the map
        epoch so a shard on a newer map refuses it explicitly ("stale
        ownership map") instead of serving a misrouted read."""
        check(self._lib, self._lib.etq_set_ownership(self._h,
                                                     spec.encode()))

    def ownership_epoch(self) -> int:
        """Installed ownership-map epoch (0 = none / local proxy)."""
        e = self._lib.etq_ownership_epoch(self._h)
        if e < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        return int(e)

    def shard_num(self) -> int:
        """Shard count this proxy was built against (1 for local)."""
        n = self._lib.etq_shard_num(self._h)
        if n < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        return int(n)

    def shard_stats(self):
        """(requests, rows) per-shard uint64 arrays since proxy init.
        Rows (split-routed ids) are the hot-shard detection signal —
        the distribute rewrite fires one REMOTE per shard per query
        regardless, so request counts alone cannot see skew."""
        n = self.shard_num()
        reqs = np.zeros(max(n, 1), dtype=np.uint64)
        rows = np.zeros(max(n, 1), dtype=np.uint64)
        got = self._lib.etq_shard_stats(
            self._h, reqs.ctypes.data_as(_libmod.c_u64p),
            rows.ctypes.data_as(_libmod.c_u64p), int(reqs.size))
        if got < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        return reqs[:got], rows[:got]

    def delta_since(self, from_epoch: int):
        """(epoch, covered, dirty_ids) — union over shards in remote
        mode; covered=False when any shard's bounded history no longer
        reaches from_epoch (treat everything as dirty)."""
        lib = self._lib
        res = lib.etres_new()
        try:
            out_epoch = ctypes.c_int64()
            covered = ctypes.c_int32()
            check(lib, lib.etq_delta_since(self._h, int(from_epoch), res,
                                           ctypes.byref(out_epoch),
                                           ctypes.byref(covered)))
            n = lib.etres_u64_len(res)
            ids = (np.ctypeslib.as_array(lib.etres_u64(res), (n,)).copy()
                   if n else np.zeros(0, dtype=np.uint64))
        finally:
            lib.etres_free(res)
        return int(out_epoch.value), bool(covered.value), ids

    def dump_index(self, directory: str) -> None:
        """Persist the local-mode index to `directory` (reference:
        serialized Index/ dir, index_manager.h:34,54). Reload later with
        Query.local(engine, index_spec="load:<directory>") — or in
        start_service — instead of rebuilding from columns."""
        check(self._lib, self._lib.etq_index_dump(self._h,
                                                  directory.encode()))

    def explain(self, gremlin: str) -> str:
        """Render what this proxy registers for `gremlin` and what a
        server's prepare-time optimizer turns that registration into:
        a "-- as registered --" DAG (the proxy's compile mode) followed
        by a "-- server optimized --" block whose header carries the
        per-pass rewrite counts (fuse/pushdown/dedup) and the
        determinism verdict that gates the result-reuse / coalescing
        fast paths. Distribute-mode note: shards optimize each REMOTE
        sub-plan they receive, so the local-form optimized block is the
        per-shard view. Pure client-side compile — nothing executes."""
        lib = self._lib
        shard_num = max(int(lib.etq_shard_num(self._h)), 1)
        mode = self._mode if shard_num > 1 else "local"

        def _probe(stage: int, m: str, n_shards: int) -> str:
            n = lib.etq_compile_debug2(gremlin.encode(), n_shards,
                                       n_shards, m.encode(), stage,
                                       None, 0)
            if n < 0:
                raise EngineError(lib.etg_last_error().decode())
            buf = ctypes.create_string_buffer(int(n) + 1)
            lib.etq_compile_debug2(gremlin.encode(), n_shards, n_shards,
                                   m.encode(), stage, buf, n + 1)
            return buf.value.decode()

        registered = _probe(0, mode, shard_num)
        # the optimizer runs on the plan a SHARD receives — local form
        optimized = _probe(1, "local", 1)
        return ("-- as registered (mode=%s, shards=%d) --\n%s"
                "-- server optimized --\n%s"
                % (mode, shard_num, registered, optimized))

    def stats(self) -> dict:
        """Per-proxy query counters: queries, errors, total_us, last_us
        (aux parity: engine-side query timing)."""
        import numpy as np

        out = np.zeros(4, dtype=np.uint64)
        with self._mu:
            if not self._h:
                raise EngineError("query proxy is closed")
            check(self._lib, self._lib.etq_stats(
                self._h, out.ctypes.data_as(_libmod.c_u64p)))
        return {"queries": int(out[0]), "errors": int(out[1]),
                "total_us": int(out[2]), "last_us": int(out[3])}

    def bind_obs(self, name: str) -> None:
        """Bridge this proxy's ENGINE-SIDE stats() counters into
        euler_tpu_torch.obs gauges (gql_proxy_*{proxy=name}), refreshed at
        every registry scrape/snapshot by a collector. The collector
        holds only a weakref: a collected or close()d proxy drops off
        the next scrape instead of pinning the native handle."""
        from euler_tpu_torch import obs

        reg = obs.default_registry()
        gauges = {
            k: reg.gauge(f"gql_proxy_{k}",
                         f"engine-side query proxy {k}",
                         ("proxy",)).labels(proxy=name)
            for k in ("queries", "errors", "total_us", "last_us")}
        ref = weakref.ref(self)

        def _collect():
            q = ref()
            if q is None or not q._h:
                return False  # proxy gone: collector self-removes
            try:
                st = q.stats()
            except EngineError:  # closed between the check and the call
                return False
            for k, v in st.items():
                g = gauges.get(k)
                if g is not None:
                    g.set(v)

        reg.add_collector(_collect)
        _ensure_udf_cache_obs()

    def close(self) -> None:
        with self._mu:
            if self._h:
                self._lib.etq_free(self._h)
                self._h = 0

    def __del__(self):  # best-effort
        try:
            self.close()
        except (EngineError, OSError, AttributeError, TypeError):
            # expected at interpreter teardown: the ctypes lib / module
            # globals may already be torn down under this object
            pass
        except Exception as e:
            _note_unexpected("query_del", e)


class GraphService:
    """A serving graph shard (reference euler.start(), python_api.cc:29)."""

    def __init__(self, lib, handle: int):
        self._lib = lib
        self._h = handle

    @property
    def port(self) -> int:
        return self._lib.ets_port(self._h)

    @property
    def epoch(self) -> int:
        """The served graph's current epoch (recovery-rejoin checks)."""
        return int(self._lib.ets_epoch(self._h))

    # -- elastic fleet -----------------------------------------------------
    def set_ownership(self, spec: str) -> int:
        """Install an epoch-versioned ownership map on this shard: the
        flip after which requests routed on an older map are refused
        ("stale ownership map", counted), deltas filter by the map's
        owner lists, and — when the shard is durable — the spec is
        persisted beside the WAL so crash recovery replays under it.
        Returns the installed map epoch (the flip_fleet contract —
        push_ownership returns the same for wire pushes)."""
        check(self._lib, self._lib.ets_set_ownership(self._h,
                                                     spec.encode()))
        return self.map_epoch

    @property
    def map_epoch(self) -> int:
        """Installed ownership-map epoch (0 = none)."""
        return int(self._lib.ets_map_epoch(self._h))

    def plan_debug(self) -> str:
        """Dump this shard's shared prepared-plan store: one block per
        registered plan — id, generation, determinism verdict, the
        prepare-time optimizer's per-pass rewrite counts, the DAG that
        actually executes, and (when rewritten) the verbatim form the
        client registered. The server half of Query.explain()."""
        lib = self._lib
        n = lib.ets_plan_debug(self._h, None, 0)
        if n < 0:
            raise EngineError(lib.etg_last_error().decode())
        buf = ctypes.create_string_buffer(int(n) + 1)
        lib.ets_plan_debug(self._h, buf, n + 1)
        return buf.value.decode()

    def stop(self) -> None:
        if self._h:
            self._lib.ets_stop(self._h)
            self._h = 0

    def __del__(self):
        try:
            self.stop()
        except (EngineError, OSError, AttributeError, TypeError):
            pass  # teardown-order races (see Query.__del__)
        except Exception as e:
            _note_unexpected("graph_service_del", e)


# ---------------------------------------------------------------------------
# Server-side timing breakdown (cross-process tracing; etg_server_trace_*)
# ---------------------------------------------------------------------------
# Axis names — order must match rpc.h ServerTraceStats::VerbSlot and the
# phase constants in rpc.cc's kExecute dispatch.
_TRACE_VERBS = ("execute", "apply_delta", "get_delta", "get_delta_log",
                "set_ownership", "meta")
_TRACE_PHASES = ("queue", "decode", "execute", "serialize")
# log2-µs bucket bounds: 1µs, 2µs, ... 2^23µs (~8.4s); index 24 is the
# overflow bucket (mirrors ServerTraceStats::kTraceBuckets).
_TRACE_BOUNDS_US = tuple(float(1 << i) for i in range(24))
# ring-record flag bits (ServerTraceRecord.flags)
TRACE_FLAG_DEADLINE_SHED = 1
TRACE_FLAG_STALE_MAP_SHED = 2
TRACE_FLAG_ERROR = 4


def server_trace_hist(verb: str = "execute",
                      phase: str = "queue") -> dict:
    """One native per-verb/per-phase server timing histogram (always
    on — no negotiation, no Python in the measurement path): the
    queue-wait / decode / execute / serialize breakdown every request
    through this process's GraphServers lands in. Returns {count,
    sum_us, buckets: [[le_us, count], ...]} with raw (non-cumulative)
    per-bucket counts; non-"execute" verbs record queue + execute
    only."""
    lib = _libmod.load()
    out = np.zeros(27, dtype=np.uint64)
    check(lib, lib.etg_server_trace_hist(
        _TRACE_VERBS.index(verb), _TRACE_PHASES.index(phase),
        out.ctypes.data_as(_libmod.c_u64p)))
    counts = [int(v) for v in out[2:]]
    return {"count": int(out[0]), "sum_us": int(out[1]),
            "buckets": [[le, c] for le, c in
                        zip(list(_TRACE_BOUNDS_US) + ["+Inf"], counts)]}


def server_phase_quantile(verb: str = "execute", phase: str = "decode",
                          q: float = 0.99, baseline: dict = None):
    """Bucket-interpolated quantile (ms) of one native server phase
    histogram — the counted ruler the wire-path work is judged by
    (accept.py's decode-phase gate, bench_host --mode wire). With
    `baseline` (a prior server_trace_hist snapshot of the SAME
    verb/phase), the quantile is computed over the DELTA since that
    snapshot, so an A/B leg reads only its own requests. None when the
    (delta) histogram is empty."""
    from euler_tpu_torch.obs.metrics import bucket_quantile

    h = server_trace_hist(verb, phase)
    counts = [c for _, c in h["buckets"]]
    if baseline is not None:
        base = [c for _, c in baseline["buckets"]]
        counts = [max(c - b, 0) for c, b in zip(counts, base)]
    if sum(counts) == 0:
        return None
    v = bucket_quantile(counts, _TRACE_BOUNDS_US, q)
    return None if v is None else v / 1000.0


def server_trace_spans() -> list:
    """Drain the bounded server-side span ring: one dict per request
    that carried a wire trace context (kFeatTrace), with the
    queue/decode/execute/serialize breakdown in µs, the client's
    trace/parent-span ids, and the server-minted span id. Read-and-
    clear — the harness dumps once per run."""
    lib = _libmod.load()
    res = lib.etres_new()
    try:
        check(lib, lib.etg_server_trace_dump(res))
        n = lib.etres_u64_len(res)
        flat = (np.ctypeslib.as_array(lib.etres_u64(res), (n,)).copy()
                if n else np.zeros(0, dtype=np.uint64))
    finally:
        lib.etres_free(res)
    out = []
    for i in range(0, flat.size, 10):
        r = flat[i:i + 10]
        out.append({
            "trace_id": int(r[0]), "parent_span": int(r[1]),
            "span_id": int(r[2]), "verb": int(r[3]), "flags": int(r[4]),
            "start_unix_us": int(r[5]), "queue_us": int(r[6]),
            "decode_us": int(r[7]), "exec_us": int(r[8]),
            "serialize_us": int(r[9]),
        })
    return out


def server_trace_chrome(path: str, spans: Optional[list] = None) -> str:
    """Export the server-side span ring (drained, unless `spans` from a
    prior server_trace_spans() call is given) as chrome://tracing JSON:
    per request one "server:execute" parent span with its queue_wait /
    decode / execute / serialize children laid out sequentially, each
    request on its own chrome tid so concurrent requests never
    corrupt nesting. args carry trace_id / parent_span (the CLIENT
    span) / span_id, so tools/trace_dump.py --merge stitches these
    under the client's graph_rpc spans on one timeline.
    otherData.epoch_unix anchors ts=0 on the wall clock, the same
    convention Tracer.chrome_trace uses."""
    import json as _json
    import os as _os
    import tempfile as _tempfile

    if spans is None:
        spans = server_trace_spans()
    epoch_us = min((s["start_unix_us"] for s in spans), default=0)
    pid = _os.getpid()
    events = []
    for s in spans:
        base = s["start_unix_us"] - epoch_us
        tid = s["span_id"] & 0xFFFFFFFF
        args = {"trace_id": s["trace_id"], "parent_span": s["parent_span"],
                "span_id": s["span_id"], "flags": s["flags"]}
        total = (s["queue_us"] + s["decode_us"] + s["exec_us"]
                 + s["serialize_us"])
        name = _TRACE_VERBS[0] if s["verb"] == 0 else f"verb{s['verb']}"
        events.append({"name": f"server:{name}", "ph": "X", "cat": "srv",
                       "ts": base, "dur": total, "pid": pid, "tid": tid,
                       "args": args})
        off = 0
        for phase, key in (("queue_wait", "queue_us"),
                           ("decode", "decode_us"),
                           ("execute", "exec_us"),
                           ("serialize", "serialize_us")):
            if s[key] == 0 and phase != "queue_wait":
                continue
            events.append({"name": phase, "ph": "X", "cat": "srv",
                           "ts": base + off, "dur": s[key], "pid": pid,
                           "tid": tid, "args": {"trace_id": s["trace_id"]}})
            off += s[key]
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"epoch_unix": epoch_us / 1e6,
                           "exporter": "euler_tpu_torch.gql.server_trace"}}
    d = _os.path.dirname(_os.path.abspath(path)) or "."
    fd, tmp = _tempfile.mkstemp(
        prefix=_os.path.basename(path) + ".", suffix=".tmp", dir=d)
    with _os.fdopen(fd, "w") as f:
        _json.dump(trace, f)
    _os.replace(tmp, path)
    return path


_server_trace_obs_done = False
_server_trace_obs_mu = threading.Lock()


def _ensure_server_trace_obs() -> None:
    """Bridge the native per-verb server timing histograms into obs
    gauges (the etg_rpc_stats → rpc_* pattern), once per process, on
    the first start_service: a /metrics scrape of one shard process
    then shows queue-wait and execute quantiles measured entirely in
    the native layer. Per (verb, phase): graph_server_phase_us_count /
    _sum, and bucket-interpolated p50/p99/p999 as
    graph_server_phase_ms_quantile{verb,phase,q}."""
    global _server_trace_obs_done
    with _server_trace_obs_mu:
        if _server_trace_obs_done:
            return
        from euler_tpu_torch import obs as _obs

        reg = _obs.default_registry()
        g_count = reg.gauge(
            "graph_server_phase_us_count",
            "server-side per-request phase observations (native)",
            ("verb", "phase"))
        g_sum = reg.gauge(
            "graph_server_phase_us_sum",
            "server-side per-request phase time total, µs (native)",
            ("verb", "phase"))
        g_q = reg.gauge(
            "graph_server_phase_ms_quantile",
            "server-side phase latency quantile, ms "
            "(bucket-interpolated from the native log2-µs histogram)",
            ("verb", "phase", "q"))

        from euler_tpu_torch.obs.metrics import bucket_quantile

        def _collect():
            for verb in _TRACE_VERBS:
                for phase in _TRACE_PHASES:
                    if verb != "execute" and phase in ("decode",
                                                       "serialize"):
                        continue  # never observed for these verbs
                    h = server_trace_hist(verb, phase)
                    if h["count"] == 0:
                        continue
                    g_count.labels(verb=verb, phase=phase).set(h["count"])
                    g_sum.labels(verb=verb, phase=phase).set(h["sum_us"])
                    counts = [c for _, c in h["buckets"]]
                    for q in (0.5, 0.99, 0.999):
                        v = bucket_quantile(counts, _TRACE_BOUNDS_US, q)
                        if v is not None:
                            g_q.labels(verb=verb, phase=phase,
                                       q=str(q)).set(v / 1000.0)

        reg.add_collector(_collect)
        _obs.register_health(
            "graph_server_trace",
            lambda: {"execute_queue": server_trace_hist("execute", "queue")
                     ["count"],
                     "execute_exec": server_trace_hist("execute", "execute")
                     ["count"]})
        # flag only after every registration succeeded (wal-obs pattern)
        _server_trace_obs_done = True


# native durability counter layout (etg_wal_stats) — order must match
# capi.cc. `degraded` is a gauge counting the process's degraded wal
# INSTANCES (shards currently refusing deltas because their log is
# unwritable); everything else is a monotonic counter.
_WAL_STAT_KEYS = (
    "appends", "fsyncs", "replayed_records", "compactions",
    "catchup_deltas", "refused", "torn_records", "degraded")

_wal_obs_done = False
_wal_obs_mu = threading.Lock()


def wal_stats() -> dict:
    """Process-global write-ahead-log durability counters: records
    appended/fsynced, records replayed at recovery, snapshot
    compactions, deltas applied via peer anti-entropy catch-up, deltas
    refused while degraded, torn/corrupt records dropped at replay, and
    the degraded gauge. Benches snapshot before/after a leg and diff."""
    lib = _libmod.load()
    out = np.zeros(len(_WAL_STAT_KEYS), dtype=np.uint64)
    lib.etg_wal_stats(out.ctypes.data_as(_libmod.c_u64p))
    return {k: int(v) for k, v in zip(_WAL_STAT_KEYS, out)}


def _ensure_wal_obs() -> None:
    """Mirror the native durability counters into obs gauges
    (wal_appends_total, wal_fsyncs_total, wal_replayed_records_total,
    wal_compactions_total, wal_recovery_catchup_deltas_total,
    wal_refused_total, wal_torn_records_total, wal_degraded) and expose
    them on /healthz via a "graph_wal" health provider — once per
    process, first durable start_service."""
    global _wal_obs_done
    with _wal_obs_mu:
        if _wal_obs_done:
            return
        from euler_tpu_torch import obs as _obs

        reg = _obs.default_registry()
        names = {
            "appends": "wal_appends_total",
            "fsyncs": "wal_fsyncs_total",
            "replayed_records": "wal_replayed_records_total",
            "compactions": "wal_compactions_total",
            "catchup_deltas": "wal_recovery_catchup_deltas_total",
            "refused": "wal_refused_total",
            "torn_records": "wal_torn_records_total",
            "degraded": "wal_degraded",
        }
        gauges = {
            k: reg.gauge(n, f"graph shard write-ahead log {k} "
                            "(process-global, native counter mirror)")
            for k, n in names.items()}

        def _collect():
            for k, v in wal_stats().items():
                gauges[k].set(v)

        reg.add_collector(_collect)
        _obs.register_health("graph_wal", wal_stats)
        # only after every registration succeeded: a raise above leaves
        # the flag unset so the next durable start retries instead of
        # permanently serving without wal observability
        _wal_obs_done = True


# native out-of-core tier counter layout (etg_store_stats) — order must
# match store.h kStoreStatSlots. Slots 10..34 are the cold-read log2-µs
# histogram buckets (the _TRACE_BOUNDS_US convention + overflow).
_STORE_STAT_KEYS = (
    "hot_hits", "cold_reads", "page_in", "page_out", "resident_bytes",
    "mapped_bytes", "hot_pinned_bytes", "attaches", "cold_n",
    "cold_sum_us")

_store_obs_done = False
_store_obs_mu = threading.Lock()


def store_stats() -> dict:
    """Process-global out-of-core storage-tier counters (store.h):
    hot-set hits vs cold row reads, mincore-observed page_in/page_out
    and resident bytes across every live mmap'd graph, hot-set pinned
    bytes, attach count, and the cold-read page-in latency histogram
    under "cold_buckets" ([[le_us, count], ...] raw per-bucket counts).
    All zeros when no graph is attached. Benches snapshot before/after
    a leg and diff."""
    lib = _libmod.load()
    out = np.zeros(10 + 25, dtype=np.uint64)
    lib.etg_store_stats(out.ctypes.data_as(_libmod.c_u64p))
    d = {k: int(v) for k, v in zip(_STORE_STAT_KEYS, out)}
    d["cold_buckets"] = [
        [le, int(c)] for le, c in
        zip(list(_TRACE_BOUNDS_US) + ["+Inf"], out[10:])]
    return d


def cold_read_quantile(q: float = 0.999, baseline: dict = None):
    """Bucket-interpolated quantile (ms) of the cold-read page-in
    latency histogram — the counted bound on the out-of-core tier's
    miss penalty (bench_host --mode outcore's p999 gate). With
    `baseline` (a prior store_stats snapshot), computes over the delta
    since it. None when the (delta) histogram is empty."""
    from euler_tpu_torch.obs.metrics import bucket_quantile

    counts = [c for _, c in store_stats()["cold_buckets"]]
    if baseline is not None:
        base = [c for _, c in baseline["cold_buckets"]]
        counts = [max(c - b, 0) for c, b in zip(counts, base)]
    if sum(counts) == 0:
        return None
    v = bucket_quantile(counts, _TRACE_BOUNDS_US, q)
    return None if v is None else v / 1000.0


def _process_rss_bytes() -> int:
    """This process's resident set size, from /proc/self/status VmRSS
    (kB). 0 where /proc is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _ensure_store_obs() -> None:
    """Mirror the out-of-core tier counters into obs gauges — the
    residency pair the 10×-RAM claim is judged by on /metrics
    (process_rss_bytes vs graph_storage_resident_bytes +
    graph_storage_mapped_bytes), plus hot/cold accounting — and expose
    a "graph_storage" health provider. Once per process, first
    storage="mmap" start_service (or explicit call)."""
    global _store_obs_done
    with _store_obs_mu:
        if _store_obs_done:
            return
        from euler_tpu_torch import obs as _obs

        reg = _obs.default_registry()
        names = {
            "hot_hits": "graph_storage_hot_hits_total",
            "cold_reads": "graph_storage_cold_reads_total",
            "page_in": "graph_storage_page_in_total",
            "page_out": "graph_storage_page_out_total",
            "resident_bytes": "graph_storage_resident_bytes",
            "mapped_bytes": "graph_storage_mapped_bytes",
            "hot_pinned_bytes": "graph_storage_hot_pinned_bytes",
        }
        gauges = {
            k: reg.gauge(n, f"out-of-core graph storage tier {k} "
                            "(process-global, native counter mirror)")
            for k, n in names.items()}
        rss = reg.gauge(
            "process_rss_bytes",
            "process resident set size (/proc/self/status VmRSS) — "
            "read against graph_storage_resident_bytes to see how much "
            "of the mapped graph the kernel is holding in RAM")

        def _collect():
            s = store_stats()
            for k in names:
                gauges[k].set(s[k])
            rss.set(_process_rss_bytes())

        reg.add_collector(_collect)
        _obs.register_health("graph_storage", store_stats)
        _store_obs_done = True


def start_service(data_dir: str, shard_idx: int = 0, shard_num: int = 1,
                  port: int = 0, registry_dir: str = "",
                  host: str = "127.0.0.1", index_spec: str = "",
                  wal_dir: str = "", wal_fsync: str = "always",
                  wal_compact_bytes: int = 64 << 20,
                  catchup: bool = True, storage: str = None,
                  hot_bytes: int = None) -> GraphService:
    """Load shard `shard_idx`/`shard_num` from data_dir and serve it.

    registry_dir: where the shard registers for discovery — a shared
    directory path (or "dir:/path"), or "tcp:<host>:<port>" pointing at
    a registry server (start_registry) for clusters with no shared
    filesystem (the reference's ZooKeeper role).

    wal_dir: non-empty makes the shard DURABLE — every accepted delta
    is appended to a checksummed write-ahead log before the snapshot
    swap, and a restart with the same wal_dir recovers snapshot+WAL to
    the pre-crash epoch, then (catchup=True, registry given) closes any
    remaining gap from a peer's retained delta log before registering
    for traffic. An unwritable wal_dir degrades gracefully: reads
    serve, every delta is refused with an explicit status (counted,
    `wal_degraded` on /healthz).
    wal_fsync: "always" fsyncs each append (survives power loss);
    "never" rides the page cache (survives process death/SIGKILL only).
    wal_compact_bytes: once the log exceeds this, the snapshot is
    re-dumped (atomic temp+rename) and the log truncated; <= 0 disables
    compaction.

    storage: "ram" (default) serves from the heap; "mmap" serves from
    the out-of-core columnar tier — the graph's big columns are mmap'd
    from a columnar store file (written beside the data files on first
    start, and by every WAL compaction thereafter), with `hot_bytes` of
    hub-first hot set pinned in RAM. Reads are byte-identical to the
    RAM engine; the page cache absorbs everything beyond the hot set,
    so the shard can serve graphs far larger than RAM at a counted
    cold-read penalty (store_stats() / cold_read_quantile()). Both
    default from the ETG_STORAGE / ETG_HOT_BYTES environment (so
    launchers flip a fleet without code changes)."""
    lib = _libmod.load()
    fsync_map = {"always": 1, "never": 0}
    if wal_fsync not in fsync_map:
        raise ValueError(
            f"wal_fsync must be one of {sorted(fsync_map)}, got "
            f"{wal_fsync!r}")
    if storage is None:
        storage = os.environ.get("ETG_STORAGE", "ram")
    storage_map = {"ram": 0, "mmap": 1}
    if storage not in storage_map:
        raise ValueError(
            f"storage must be one of {sorted(storage_map)}, got "
            f"{storage!r}")
    if hot_bytes is None:
        hot_bytes = int(os.environ.get("ETG_HOT_BYTES", "0"))
    if wal_dir:
        _ensure_wal_obs()
    if storage == "mmap":
        _ensure_store_obs()
    # every serving shard process exposes its native timing breakdown
    # (queue-wait/execute quantiles) on /metrics — no opt-in needed
    _ensure_server_trace_obs()
    h = lib.ets_start3(data_dir.encode(), shard_idx, shard_num, port,
                       registry_dir.encode(), host.encode(),
                       index_spec.encode(), wal_dir.encode(),
                       fsync_map[wal_fsync], int(wal_compact_bytes),
                       1 if catchup else 0, storage_map[storage],
                       int(hot_bytes))
    if h == 0:
        raise EngineError(lib.etg_last_error().decode())
    return GraphService(lib, h)


class RegistryService:
    """A TCP registry server (ZK-role discovery without a shared FS):
    shards heartbeat named entries; clients and monitors list them with
    ages. Use "tcp:<host>:<port>" as registry_dir / endpoints."""

    def __init__(self, lib, handle: int):
        self._lib = lib
        self._h = handle

    @property
    def port(self) -> int:
        return self._lib.etr_port(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.etr_stop(self._h)
            self._h = 0

    def __del__(self):
        try:
            self.stop()
        except (EngineError, OSError, AttributeError, TypeError):
            pass  # teardown-order races (see Query.__del__)
        except Exception as e:
            _note_unexpected("registry_service_del", e)


def start_registry(port: int = 0) -> RegistryService:
    """Start a registry server (port 0 → ephemeral)."""
    lib = _libmod.load()
    h = lib.etr_start(port)
    if h == 0:
        raise EngineError(lib.etg_last_error().decode())
    return RegistryService(lib, h)


def push_ownership(host: str, port: int, spec: str) -> int:
    """Push an ownership-map spec to one graph shard over the
    kSetOwnership admin verb (the elastic driver's flip for servers it
    does not hold an in-process handle to — e.g. subprocess shards).
    Returns the installed map epoch."""
    lib = _libmod.load()
    out = ctypes.c_int64()
    check(lib, lib.etg_push_ownership(host.encode(), int(port),
                                      spec.encode(), ctypes.byref(out)))
    return int(out.value)


def scan_registry(spec: str):
    """List a registry's shard entries: {shard: (host, port, age_ms)}.
    spec = directory path, "dir:/path", or "tcp:host:port"."""
    lib = _libmod.load()
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.etr_scan(spec.encode(), buf, len(buf))
    if n < 0:
        raise EngineError(lib.etg_last_error().decode())
    if n >= len(buf):  # truncated: re-scan with the reported size
        buf = ctypes.create_string_buffer(n + 1)
        n = lib.etr_scan(spec.encode(), buf, len(buf))
        if n < 0:
            raise EngineError(lib.etg_last_error().decode())
    out = {}
    for line in buf.value.decode().splitlines():
        idx, host, port, age = line.split(",")
        out[int(idx)] = (host, int(port), int(age))
    return out


# ctypes callbacks must outlive the engine; keyed by name so
# re-registration replaces (matching the registry's last-wins rule)
_UDF_CALLBACKS: Dict[str, object] = {}

_UDF_CBTYPE = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # params
    _libmod.c_u64p, ctypes.c_int64,                    # offsets, n_rows
    _libmod.c_f32p, ctypes.c_int64,                    # values, n_vals
    ctypes.c_void_p)                                   # out builder


def register_udf(name: str, fn) -> None:
    """Register a custom value-UDF callable from GQL `udf(name, feat)`
    (reference udf.h:33-68 UDF registration, here via ctypes so no
    recompilation is needed).

    fn(params, offsets, values) -> (out_offsets, out_values):
      params  float64 [P] — numeric params from "udf(name:p1:p2, feat)"
      offsets uint64 [n+1], values float32 [offsets[-1]] — ragged rows
    Both outputs are converted with np.asarray; out_offsets must have
    one more entry than output rows.

    Note: in distribute mode the UDF executes on the shard SERVERS —
    register it in each server process as well.

    PURITY: dense-feature UDF results are cached (UdfResultCache; see
    udf_cache_stats) keyed on the graph + spec + ids, so fn MUST be a
    pure function of (params, offsets, values). Re-registering a name
    invalidates all cached results; a deliberately stateful or random
    UDF should disable the cache with udf_cache_set_capacity(0).
    """
    lib = _libmod.load()
    _ensure_udf_cache_obs()  # local-mode UDF users get the gauges too

    @_UDF_CBTYPE
    def cb(params, n_params, offs, n_rows, vals, n_vals, out):
        try:
            p = np.ctypeslib.as_array(params, (n_params,)) if n_params \
                else np.zeros(0)
            o = np.ctypeslib.as_array(offs, (n_rows + 1,))
            v = np.ctypeslib.as_array(vals, (n_vals,)) if n_vals \
                else np.zeros(0, np.float32)
            out_o, out_v = fn(p.copy(), o.copy(), v.copy())
            out_o = np.ascontiguousarray(out_o, dtype=np.uint64)
            out_v = np.ascontiguousarray(out_v, dtype=np.float32)
            if out_o.size == 0 or out_o[0] != 0 or out_o[-1] != out_v.size:
                raise ValueError(
                    f"udf {name!r}: offsets must start at 0 and end at "
                    f"len(values) ({out_o[-1] if out_o.size else '?'} != "
                    f"{out_v.size})")
            lib.et_udf_emit(out, out_o.ctypes.data_as(_libmod.c_u64p),
                            out_o.size,
                            out_v.ctypes.data_as(_libmod.c_f32p),
                            out_v.size)
            return 0
        except (ValueError, TypeError):
            # malformed UDF output / non-convertible arrays: the
            # expected failure mode — rc=1 surfaces it as a query error
            return 1
        except Exception as e:
            # a genuinely unexpected bug in the user fn (or this
            # trampoline) must not vanish behind the same rc=1: count
            # it where /metrics can see it, then fail the query
            _note_unexpected("udf_cb", e)
            return 1

    _UDF_CALLBACKS[name] = cb
    lib.etg_register_udf(name.encode(), ctypes.cast(cb, ctypes.c_void_p))


def udf_cache_stats() -> dict:
    """UDF result-cache counters (reference UdfCache, udf.h:33-68):
    {'hits', 'misses', 'entries', 'bytes', 'epoch_evictions'}. Cached
    results are keyed on the graph SNAPSHOT's uid + registry generation
    + spec + fid + ids, so entries never go stale — a streaming delta
    swaps in a new snapshot (new uid) and the old snapshot's entries
    are dropped at the bump (epoch_evictions counts them, mirrored as
    udf_cache_epoch_evictions_total); re-registering any UDF orphans
    old entries, and eviction is size-bounded LRU."""
    lib = _libmod.load()
    h = ctypes.c_uint64()
    m = ctypes.c_uint64()
    e = ctypes.c_uint64()
    b = ctypes.c_uint64()
    lib.etg_udf_cache_stats(ctypes.byref(h), ctypes.byref(m),
                            ctypes.byref(e), ctypes.byref(b))
    return {"hits": h.value, "misses": m.value, "entries": e.value,
            "bytes": b.value,
            "epoch_evictions": int(lib.etg_udf_cache_epoch_evictions())}


_udf_obs_once = threading.Lock()
_udf_obs_done = False


def _ensure_udf_cache_obs() -> None:
    """Register (once per process) the collector mirroring the native
    UDF result-cache counters into gql_udf_cache_* gauges. Called from
    bind_obs — i.e. only after the native lib is known to be loaded, so
    a /metrics scrape never triggers a first-time lib build."""
    global _udf_obs_done
    with _udf_obs_once:
        if _udf_obs_done:
            return
        _udf_obs_done = True
    from euler_tpu_torch import obs

    reg = obs.default_registry()
    gauges = {k: reg.gauge(f"gql_udf_cache_{k}",
                           f"UDF result-cache {k} (see udf_cache_stats)")
              for k in ("hits", "misses", "entries", "bytes")}
    # epoch-bump invalidation count (streaming deltas) keeps the
    # counter-style *_total name the satellite dashboards expect
    gauges["epoch_evictions"] = reg.gauge(
        "udf_cache_epoch_evictions_total",
        "UDF result-cache entries dropped by graph epoch bumps")

    def _collect():
        for k, v in udf_cache_stats().items():
            g = gauges.get(k)
            if g is not None:
                g.set(v)

    reg.add_collector(_collect)


def udf_cache_clear() -> None:
    """Drop every cached UDF result (testing / memory pressure)."""
    _libmod.load().etg_udf_cache_clear()


def udf_cache_set_capacity(num_bytes: int) -> None:
    """Resize the UDF result cache (default 64MB; 0 disables caching)."""
    _libmod.load().etg_udf_cache_set_capacity(num_bytes)


def compile_debug(gremlin: str, shard_num: int = 1, partition_num: int = 1,
                  mode: str = "local") -> str:
    """Compile and render the optimized DAG (golden structure tests)."""
    lib = _libmod.load()
    n = lib.etq_compile_debug(gremlin.encode(), shard_num, partition_num,
                              mode.encode(), None, 0)
    if n < 0:
        raise EngineError(lib.etg_last_error().decode())
    buf = ctypes.create_string_buffer(int(n) + 1)
    lib.etq_compile_debug(gremlin.encode(), shard_num, partition_num,
                          mode.encode(), buf, n + 1)
    return buf.value.decode()
