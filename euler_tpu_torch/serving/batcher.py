"""Dynamic micro-batching with admission control and load shedding
(copy of euler_tpu/serving/batcher.py over the port's obs copy; the
port imports nothing of euler_tpu).

The serving hot path's throughput lever: individual queries are tiny
(a handful of ids), but the per-dispatch cost — a device apply with
its host↔device copies, or an injected RPC RTT — is fixed, so the server coalesces concurrent
requests into one batch. Two flush triggers, whichever fires first:

  * the pending batch reaches ``max_batch`` rows (flush immediately);
  * the OLDEST pending request has waited ``flush_ms`` (bounded added
    latency — an idle server never delays a lone request longer than
    the window).

Admission control: past ``max_queue`` queued rows, submit() raises
ShedError synchronously — the caller turns that into an explicit SHED
reply. Shedding at admission (not after queueing) keeps the latency of
ADMITTED requests bounded by queue_depth/throughput instead of growing
without limit; sheds are counted, never silent.

Bucketed shapes: `bucket_ladder` / `run_bucketed` pad flush batches to
a fixed geometric ladder of row counts so a device apply sees only
ladder shapes — after one warmup pass per bucket the caching allocator
holds a block of every size steady state asks for, whatever request
sizes arrive (the reference's reason is its jit: no recompiles).

Metrics ({batcher=name} children on the obs registry):
  serving_batch_rows / serving_batch_requests / serving_queue_wait_ms
  histograms, serving_flushes_total{reason=full|timer},
  serving_shed_total, serving_inflight_rows gauge.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from euler_tpu_torch import obs as _obs

__all__ = ["ShedError", "MicroBatcher", "bucket_ladder", "run_bucketed",
           "warm_ladder"]

_BATCHER_IDS = itertools.count()


class ShedError(RuntimeError):
    """Request refused by admission control (queue full) or abandoned
    at shutdown — ALWAYS surfaced explicitly, client-visible as a SHED
    status, never a silent drop."""


def bucket_ladder(max_batch: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Geometric (×2) padded-shape ladder up to max_batch: every flush
    pads to one of these row counts, so an apply sees at most
    len(ladder) shapes."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    ladder = []
    b = min(min_bucket, max_batch)
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def run_bucketed(fn: Callable[..., np.ndarray],
                 arrays: Sequence[np.ndarray],
                 ladder: Sequence[int]) -> np.ndarray:
    """Apply `fn` over equal-length row arrays using ONLY ladder-sized
    (edge-padded) chunks; returns fn's rows trimmed back to the true
    length. A batch longer than the largest bucket runs as several
    largest-bucket chunks — shapes stay inside the ladder either way."""
    n = arrays[0].shape[0]
    outs = []
    at = 0
    while at < n:
        remaining = n - at
        bucket = next((b for b in ladder if b >= remaining), ladder[-1])
        take = min(bucket, remaining)
        chunk = []
        for a in arrays:
            c = a[at:at + take]
            if take < bucket:
                pad = np.repeat(c[-1:], bucket - take, axis=0) if take \
                    else np.zeros((bucket,) + c.shape[1:], c.dtype)
                c = np.concatenate([c, pad])
            chunk.append(c)
        outs.append(np.asarray(fn(*chunk))[:take])
        at += take
    return outs[0] if len(outs) == 1 else np.concatenate(outs)


def warm_ladder(ladder: Sequence[int], *fns: Callable[[np.ndarray],
                                                      object]) -> None:
    """Run a version-scoped pool of applies once at every ladder
    bucket. Each fn takes one int32 rows array sized to the bucket.
    Used at server startup AND before a hot-swap flips the serving
    pointer: a freshly loaded bundle's applies are warmed OFF-PATH, so
    neither a first request nor a just-promoted bundle pays a first
    call's set-up inside a client's deadline."""
    for b in ladder:
        rows = np.zeros(int(b), np.int32)
        for fn in fns:
            fn(rows)


class _Pending:
    __slots__ = ("payload", "rows", "future", "t_enq")

    def __init__(self, payload, rows: int):
        self.payload = payload
        self.rows = rows
        self.future: Future = Future()
        self.t_enq = time.monotonic()


class MicroBatcher:
    """Coalesces submit()ed requests into run_batch calls on a worker
    thread.

    run_batch(payloads: list) -> list of per-request results (same
    order/length); a raise fails every request in the flush with that
    exception. `rows` passed to submit() is the request's contribution
    to batch-size accounting (ids in the request, not 1 per request).
    """

    def __init__(self, run_batch: Callable[[List], List], *,
                 max_batch: int = 256, flush_ms: float = 2.0,
                 max_queue: int = 0, name: Optional[str] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.flush_ms = float(flush_ms)
        # default queue bound: 8 full batches of headroom
        self.max_queue = int(max_queue) if max_queue else 8 * self.max_batch
        self.name = name or f"batcher{next(_BATCHER_IDS)}"
        self._mu = threading.Condition()
        self._queue: List[_Pending] = []
        self._queued_rows = 0
        self._closed = False
        reg = _obs.default_registry()
        lab = {"batcher": self.name}
        self._hist_rows = reg.histogram(
            "serving_batch_rows", "rows per flushed micro-batch",
            ("batcher",)).labels(**lab)
        self._hist_reqs = reg.histogram(
            "serving_batch_requests", "requests per flushed micro-batch",
            ("batcher",)).labels(**lab)
        self._hist_wait = reg.histogram(
            "serving_queue_wait_ms",
            "admission→flush wait per request", ("batcher",)).labels(**lab)
        self._ctr_shed = reg.counter(
            "serving_shed_total",
            "requests refused by admission control",
            ("batcher",)).labels(**lab)
        self._ctr_flush = reg.counter(
            "serving_flushes_total", "micro-batch flushes",
            ("batcher", "reason"))
        self._g_inflight = reg.gauge(
            "serving_inflight_rows",
            "rows queued + in the running flush", ("batcher",)
        ).labels(**lab)
        self._worker = threading.Thread(
            target=self._loop, name=f"microbatch-{self.name}", daemon=True)
        self._worker.start()

    # -- submission --------------------------------------------------------
    def submit(self, payload, rows: int = 1) -> Future:
        """Queue one request; returns its Future. Raises ShedError
        synchronously when admission control refuses (queue full or
        batcher closed) — the shed is counted and explicit."""
        rows = max(int(rows), 1)
        with self._mu:
            if self._closed:
                raise ShedError("batcher closed")
            if self._queued_rows + rows > self.max_queue \
                    and self._queue:  # never shed into an empty queue
                self._ctr_shed.inc()
                raise ShedError(
                    f"overloaded: {self._queued_rows} rows queued "
                    f"(max_queue={self.max_queue})")
            p = _Pending(payload, rows)
            self._queue.append(p)
            self._queued_rows += rows
            self._g_inflight.set(self._queued_rows)
            self._mu.notify_all()
        return p.future

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return self._queued_rows

    # -- worker ------------------------------------------------------------
    def _take_flush(self) -> Optional[Tuple[List[_Pending], str]]:
        """Block until a flush is due; pop it FIFO. None at close."""
        with self._mu:
            while True:
                if self._queue:
                    now = time.monotonic()
                    rows = 0
                    for p in self._queue:
                        rows += p.rows
                        if rows >= self.max_batch:
                            break
                    due = self._queue[0].t_enq + self.flush_ms / 1000.0
                    if rows >= self.max_batch:
                        reason = "full"
                    elif self._closed or now >= due:
                        reason = "timer"
                    else:
                        self._mu.wait(due - now)
                        continue
                    batch, total = [], 0
                    while self._queue:
                        nxt = self._queue[0]
                        if batch and total + nxt.rows > self.max_batch:
                            break
                        batch.append(self._queue.pop(0))
                        total += nxt.rows
                    self._queued_rows -= total
                    # inflight covers the running flush until it lands
                    self._g_inflight.set(self._queued_rows + total)
                    return batch, reason
                if self._closed:
                    return None
                self._mu.wait()

    def _loop(self) -> None:
        while True:
            taken = self._take_flush()
            if taken is None:
                return
            batch, reason = taken
            now = time.monotonic()
            for p in batch:
                # per-request queue wait, stamped onto the Future BEFORE
                # it resolves so the server's phase breakdown
                # (InferenceServer._wait → serving_phase_ms / request
                # spans) can read it after result() without extra
                # plumbing through the batcher API
                p.future.queue_wait_ms = (now - p.t_enq) * 1000.0
                self._hist_wait.observe(p.future.queue_wait_ms)
            self._hist_rows.observe(sum(p.rows for p in batch))
            self._hist_reqs.observe(len(batch))
            self._ctr_flush.labels(batcher=self.name, reason=reason).inc()
            try:
                results = self._run_batch([p.payload for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(batch)} requests")
            except BaseException as e:
                exec_ms = (time.monotonic() - now) * 1000.0
                for p in batch:
                    p.future.exec_ms = exec_ms
                    if not p.future.done():
                        p.future.set_exception(e)
            else:
                # the flush's run time, attributed to every coalesced
                # request in it (micro-batching makes execute a shared
                # phase — that sharing is exactly what the breakdown
                # should show)
                exec_ms = (time.monotonic() - now) * 1000.0
                for p, r in zip(batch, results):
                    p.future.exec_ms = exec_ms
                    if not p.future.done():
                        p.future.set_result(r)
            finally:
                with self._mu:
                    self._g_inflight.set(self._queued_rows)

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop the worker. drain=True (default) flushes everything
        already admitted first; drain=False fails queued requests with
        ShedError (explicit, not a silent drop)."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if not drain:
                abandoned, self._queue = self._queue, []
                self._queued_rows = 0
                for p in abandoned:
                    self._ctr_shed.inc()
                    if not p.future.done():
                        p.future.set_exception(
                            ShedError("batcher shut down"))
            self._mu.notify_all()
        self._worker.join(timeout=10.0)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
