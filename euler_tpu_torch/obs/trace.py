"""Tracing: `span()` context managers → a bounded ring of finished
spans → chrome://tracing JSON.

Copy of euler_tpu/obs/trace.py (stdlib only); tests/test_torch_obs.py
pins it to the original.

The tracing half of euler_tpu_torch.obs. A span is a named, attributed wall-
clock interval; nesting is tracked per-thread (a span opened while
another is active on the same thread records that span as its parent),
so the exported trace shows e.g. a `graph_rpc` span nested under the
train loop's `input_wait` phase without any plumbing between the two
layers.

Finished spans land in an in-memory ring (deque with maxlen — O(1)
append, old spans fall off; tracing a week-long run cannot OOM the
host). `chrome_trace()` / `export()` render the ring as the Trace Event
Format JSON that chrome://tracing and https://ui.perfetto.dev load
directly — complete "X" (duration) events with microsecond `ts`/`dur`.

Disabled-path cost: when the tracer (or the whole subsystem, see
euler_tpu_torch.obs.disable()) is off, `span()` returns a shared no-op
singleton — one attribute check, no allocation.

`Tracer.range_hook` (None here) lets a module outside this stdlib-only
one mirror spans elsewhere: called with a span's name as the span
opens, it returns a context manager (or None) that is entered then and
left as the span closes, on the span's own thread.
euler_tpu_torch/obs/device.py installs torch's profiler ranges there.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import random
import tempfile
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "Span", "NULL_SPAN"]


class _NullSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()
    span_id = 0
    parent_id = 0
    trace_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One wall-clock interval. Use as a context manager; `set(**attrs)`
    attaches attributes mid-flight (they export under chrome `args`).

    `trace_id` correlates spans ACROSS processes: a root span (no parent
    on its thread) draws a fresh process-unique 64-bit trace id at
    __enter__, children inherit their parent's. The graph client stamps
    (trace_id, span_id) into v2 request frames so a shard's server-side
    timing breakdown stitches under this span in a merged trace."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "trace_id", "_t0", "ts_us", "dur_us", "tid", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = 0
        self.trace_id = 0
        self._t0 = 0.0
        self.ts_us = 0.0
        self.dur_us = 0.0
        self.tid = 0
        self._range = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        if stack:
            self.parent_id = stack[-1].span_id
            self.trace_id = stack[-1].trace_id
        else:
            # a new root: fresh trace id (process-unique base + counter
            # so two processes' traces can never collide in a merge)
            self.trace_id = tr._trace_base + next(tr._trace_ids)
        stack.append(self)
        self.tid = threading.get_ident()
        hook = tr.range_hook
        if hook is not None:
            self._range = hook(self.name)
            if self._range is not None:
                self._range.__enter__()
        self._t0 = time.perf_counter()
        self.ts_us = (self._t0 - tr._epoch) * 1e6
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_us = (time.perf_counter() - self._t0) * 1e6
        tr = self._tracer
        stack = tr._stack()
        # pop self even if an inner span leaked (defensive: a span that
        # escaped its with-block must not reparent the rest of the run)
        while stack and stack.pop() is not self:
            pass
        if self._range is not None:
            self._range.__exit__(*exc)
        tr._record(self)
        return False


class Tracer:
    """Span factory + bounded ring of finished spans."""

    # name -> context manager or None, mirrored around each span (see
    # the module docstring)
    range_hook = None

    def __init__(self, capacity: int = 65536):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        # trace-id space: 64-bit random base (never 0) + counter — ids
        # stay unique across the processes a merged trace combines
        self._trace_base = (random.getrandbits(63) | (1 << 62)) & ~0xFFFFF
        self._trace_ids = itertools.count(1)
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        self.enabled = True

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record(self, span: Span) -> None:
        with self._mu:
            self._ring.append(span)

    def span(self, name: str, **attrs):
        """A new span (or the shared no-op when tracing is off)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def current_span(self):
        """Innermost active span on THIS thread (None outside any)."""
        st = self._stack()
        return st[-1] if st else None

    # -- ring access -------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._mu:
            return list(self._ring)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """Trace Event Format dict: complete ("ph": "X") events with
        microsecond ts/dur, one chrome 'thread' per real thread, span/
        trace ids and parents under args. Loadable by chrome://tracing
        and Perfetto as-is; `otherData.epoch_unix` anchors ts=0 on the
        wall clock so tools/trace_dump.py --merge can align exports
        from different processes onto one timeline.

        Safe under concurrent recording: the ring is snapshotted under
        the tracer lock and each span's attrs dict is copied before
        iteration (a recording thread may still be attaching attributes
        to a span another thread is exporting — the harness dumps
        traces while load is draining)."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            args = {"span_id": s.span_id, "parent_id": s.parent_id,
                    "trace_id": s.trace_id}
            # dict(...) snapshots attrs: iterating the live dict races
            # a concurrent sp.set() ("dict changed size during
            # iteration"). The copy itself is safe — dict reads/writes
            # are GIL-atomic per op and copy retries internally.
            for k, v in dict(s.attrs).items():
                args[k] = v if isinstance(v, (int, float, bool, str)) \
                    or v is None else str(v)
            events.append({
                "name": s.name, "ph": "X", "cat": "obs",
                "ts": round(s.ts_us, 3), "dur": round(s.dur_us, 3),
                "pid": pid, "tid": s.tid, "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix": self._epoch_unix,
                "exporter": "euler_tpu_torch.obs",
            },
        }

    def export(self, path: str) -> str:
        """Write chrome_trace() JSON to `path` (atomic rename). Returns
        the path; view with chrome://tracing, ui.perfetto.dev, or
        `python tools/trace_dump.py <path>`. Concurrency-safe: the temp
        file is unique per call (two threads exporting to the same path
        used to share one ".tmp" and could interleave writes into a
        corrupt file), and recording threads may keep appending spans
        throughout."""
        trace = self.chrome_trace()
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                                   suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path
