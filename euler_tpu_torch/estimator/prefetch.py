"""Background batch prefetchers: overlap host-side graph sampling with
device compute (the role of the reference's async TF queue runners /
one-RPC fanout amortization, SURVEY.md §7 hard part (b)).

Copy of euler_tpu/estimator/prefetch.py (stdlib only; the port imports
nothing of euler_tpu); tests/test_torch_obs.py pins it to the original.
In the port a `transform` that moves a batch to the card (the
estimator's `_to_device`: a pinned, non-blocking copy) runs in the
feeder thread, as bench.py's `_make_to_dev` does. Each feeder thread
times its work per batch, as spans with histograms labelled by the
feeder's name: `feeder_source` (next() on the source, or the batch
factory's call; feeder_source_ms) and `feeder_transform` (the transform;
feeder_transform_ms). A source that ends adds one `feeder_source` for
the call that says so.

Two shapes:

  * Prefetcher — one producer thread keeping `depth` batches ready
    ahead of a consumer (the original single-worker overlap).
  * ParallelPrefetcher — K worker threads each independently producing
    batches from a thread-safe source, delivered strictly IN TICKET
    ORDER through a bounded reorder buffer: the multi-worker feeder
    mode BaseEstimator enables with params["feeder_workers"] (ISSUE 4
    — the host feeder, not the device step, is the measured ceiling of
    every host-fed path).

Both are context managers and MUST be close()d (or abandoned only via
`with`): an abandoned consumer used to leak a daemon thread blocked on
q.put forever.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Iterator, Optional, Union

from euler_tpu_torch import obs as _obs

_FEEDER_IDS = itertools.count()


class _FeederTimes:
    """A feeder's `feeder_source` / `feeder_transform` spans and their
    millisecond histograms, labelled by the feeder's name."""

    def __init__(self, name: str):
        reg = _obs.default_registry()
        self._name = name
        self._source = reg.histogram(
            "feeder_source_ms", "per-batch host ms of next() on the "
            "feeder's source", ("feeder",)).labels(feeder=name)
        self._transform = reg.histogram(
            "feeder_transform_ms", "per-batch host ms of the feeder's "
            "transform (the estimator's: the copy to the card)",
            ("feeder",)).labels(feeder=name)

    def source(self):
        return _obs.timed_span("feeder_source", self._source,
                               feeder=self._name)

    def transform(self):
        return _obs.timed_span("feeder_transform", self._transform,
                               feeder=self._name)


class Prefetcher:
    """Wraps an iterator; a daemon thread keeps `depth` batches ready."""

    _STOP = object()

    def __init__(self, it: Iterator, depth: int = 2, transform=None):
        """transform (optional) runs on each batch IN the prefetch thread —
        pass a copy to the card to overlap host→device transfer with
        device compute, not just graph sampling. The feeder's histograms
        are labelled feeder<N>."""
        self._it = iter(it)
        self._transform = transform
        self._times = _FeederTimes(f"feeder{next(_FEEDER_IDS)}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while True:
                with self._times.source():
                    item = next(self._it, self._STOP)
                if item is self._STOP:
                    break
                if self._transform is not None:
                    with self._times.transform():
                        item = self._transform(item)
                # bounded put that can be interrupted: close() sets the
                # flag and drains, so a producer parked on a full queue
                # always wakes up and exits instead of leaking
                while not self._closed.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._closed.is_set():
                    return
        except Exception as e:  # surfaced on next()
            self._err = e
        finally:
            while not self._closed.is_set():
                try:
                    self._q.put(self._STOP, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._STOP:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer thread and reclaim it: sentinel + drain.
        Safe to call more than once; next() afterwards raises
        StopIteration."""
        self._closed.set()
        while self._thread.is_alive():
            try:  # free a producer parked in put()
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.05)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ParallelPrefetcher:
    """K sampler threads → ordered bounded queue → optional transform.

    source is either
      * a zero-arg callable producing ONE batch per call — it must be
        thread-safe; workers call it concurrently (genuinely parallel
        sampling; NodeEstimator._train_batch_factory provides one), or
      * an iterator — next() is serialized under a lock, so only the
        transform and queue depth overlap (the safe fallback for
        stateful generators).

    Delivery is strictly in ticket order: worker k claims sequence
    numbers under a lock and parks results in a bounded reorder buffer
    (`depth` outstanding tickets), so the consumer sees the same batch
    order as a single-threaded feeder over the same source. A batch
    that RAISES delivers its error at its sequence position and the
    stream then CONTINUES — the estimator's resilient input path can
    retry without tearing the feeder down. StopIteration from an
    iterator source ends the stream.

    Reports feeder_queue_depth{feeder=...} (ready batches waiting) and
    feeder_batches_total through euler_tpu.obs.
    """

    # a raised batch does NOT kill the stream — the estimator's input
    # retry path checks this instead of recreating the iterator
    resilient = True

    def __init__(self, source: Union[Callable, Iterator],
                 workers: int = 4, depth: Optional[int] = None,
                 transform=None, name: Optional[str] = None):
        self._transform = transform
        if callable(source):
            self._pull = source
            self._pull_mu = None
        else:
            it = iter(source)
            # iterator mode: ticket claim + next(it) must be ONE
            # critical section — claiming first and pulling under a
            # separate lock lets a later ticket receive an earlier
            # item (order broken) and, at end-of-stream, park "end"
            # BEFORE the real final batch (batch silently dropped)
            self._pull = lambda: next(it)
            self._pull_mu = threading.Lock()
        self.workers = max(int(workers), 1)
        self._depth = max(int(depth) if depth else 2 * self.workers,
                          self.workers)
        self._cond = threading.Condition()
        self._next_ticket = 0      # next sequence a worker claims
        self._next_out = 0         # next sequence the consumer emits
        self._ready = {}           # seq -> (kind, payload)
        self._closed = False
        self._ended = False        # iterator source exhausted
        self._name = name or f"feeder{next(_FEEDER_IDS)}"
        reg = _obs.default_registry()
        lab = {"feeder": self._name}
        self._g_depth = reg.gauge(
            "feeder_queue_depth",
            "ready batches parked in the reorder buffer",
            ("feeder",)).labels(**lab)
        self._ctr_batches = reg.counter(
            "feeder_batches_total", "batches produced by feeder workers",
            ("feeder",)).labels(**lab)
        self._times = _FeederTimes(self._name)
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"euler-{self._name}-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def _claim(self):
        """Next ticket number, honoring the backlog bound; None when
        closed/ended."""
        with self._cond:
            while (not self._closed and not self._ended
                   and self._next_ticket - self._next_out
                   >= self._depth):
                self._cond.wait(0.1)
            if self._closed or self._ended:
                return None
            seq = self._next_ticket
            self._next_ticket += 1
            return seq

    def _claim_and_pull(self):
        """(seq, result) — factory mode claims then pulls concurrently;
        iterator mode does both under the pull lock so ticket order ==
        source order (and "end" is provably the LAST ticket)."""
        if self._pull_mu is None:
            seq = self._claim()
            if seq is None:
                return None, None
        else:
            self._pull_mu.acquire()
        try:
            if self._pull_mu is not None:
                seq = self._claim()
                if seq is None:
                    return None, None
            try:
                with self._times.source():
                    return seq, ("ok", self._pull())
            except StopIteration:
                return seq, ("end", None)
            except BaseException as e:   # delivered in-order, once
                return seq, ("err", e)
        finally:
            if self._pull_mu is not None:
                self._pull_mu.release()

    def _work(self):
        while True:
            seq, res = self._claim_and_pull()
            if seq is None:
                return
            # transform stays OUTSIDE the pull lock: in iterator mode
            # it is the part that actually parallelizes
            if res[0] == "ok" and self._transform is not None:
                try:
                    with self._times.transform():
                        res = ("ok", self._transform(res[1]))
                except BaseException as e:
                    res = ("err", e)
            with self._cond:
                if self._closed:
                    return
                self._ready[seq] = res
                self._g_depth.set(len(self._ready))
                self._cond.notify_all()
                if res[0] == "end":
                    self._ended = True
                    return

    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while True:
                if self._closed:
                    raise StopIteration
                res = self._ready.pop(self._next_out, None)
                if res is None:
                    if self._ended and self._next_out >= self._next_ticket:
                        raise StopIteration
                    self._cond.wait(0.1)
                    continue
                self._next_out += 1
                self._g_depth.set(len(self._ready))
                self._cond.notify_all()
                kind, payload = res
                if kind == "ok":
                    self._ctr_batches.inc()
                    return payload
                if kind == "end":
                    # workers past the end parked "end" too; everything
                    # after the first is equivalent
                    raise StopIteration
                raise payload            # kind == "err": stream continues

    def close(self) -> None:
        """Stop all workers and reclaim their threads. Idempotent;
        next() afterwards raises StopIteration."""
        with self._cond:
            self._closed = True
            self._ready.clear()
            self._g_depth.set(0)
            self._cond.notify_all()
        for t in self._threads:
            t.join(5.0)

    def __enter__(self) -> "ParallelPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_feeder(source, workers: int = 0, depth: Optional[int] = None,
                transform=None):
    """The one constructor the tools share: workers > 1 → a
    ParallelPrefetcher over `source` (an iterator, or a thread-safe
    zero-arg BATCH factory); workers <= 1 → the single-thread
    Prefetcher (a callable source is looped as a batch factory)."""
    if workers and workers > 1:
        return ParallelPrefetcher(source, workers=workers, depth=depth,
                                  transform=transform)
    it = iter(source, object()) if callable(source) else source
    return Prefetcher(it, depth=depth or 2, transform=transform)
