"""Device phase times of a training update, and obs spans on torch's
profiler timeline: the torch-aware half of euler_tpu_torch.obs. The
package's __init__ does not re-export it and stays the reference's
stdlib-only API.

Phases. An update (parallel.train.spmd_update, under a recorder's
`update()`) is cut at marks: its start, then `sample` (the end of the
model's own draw: DeviceSampledGraphSage.sample_rows,
DeviceSampledUnsupervisedSage.sample with its positives and negatives),
`forward` (model(batch) has returned), `backward` (loss.backward() and
reduce_gradients done) and `optimizer` (the non-finite guard and
optimizer.step() done). A phase runs from the mark before it to its own
mark: a model that draws nothing of its own has no `sample`, and its
`forward` runs from the start. A phase's first mark in an update counts
and a repeated one is ignored. A mark on a thread with no update open
(an eval forward, a draw the caller makes) records nothing.

A model may also cut its forward (FORWARD_PHASES): the genie encoder
(utils/encoders.py GenieEncoder) marks `gather` (every hop's rows taken
and dequantized: its input is there), `breadth` (the projection, each
depth's attention pools and tanh transforms, depth_fc) and `depth` (the
LSTM), so its `forward` is the rest: the head and the loss. Their
histograms are made on a phase's first read: an estimator whose model
never marks them observes the four phases alone.

A mark on the card is a one-thread kernel (csrc/globaltimer.cu) that
writes the GPU's global nanosecond timer to the step's slot of a small
device buffer. Captured into a CUDA graph it is an ordinary kernel node,
which every replay runs again. (A timing event recorded into the graph
is an event-record node instead; with 160 of them in a K = 32 replay of
the GraphSAGE step on an H100, each launch held the host for a good part
of the replay, and the feeder's copies to the card with it.) On the CPU
a mark is time.perf_counter(). The
recorder reads marks only after a synchronize that the train loop
already makes: the log hook's read of the last window's losses, and
train()'s final copy of them. collect() takes the steps whose marks
have completed (an event recorded after each eager step or replay,
queried, which never waits) and observes each phase's milliseconds
into estimator_phase_device_ms{estimator=, phase=}. Of a K-step graph
only the replay that finished before a read can be read: the next
replay writes over the same buffers, so the replays between two reads
go unobserved. Eager steps are each read (the newest PENDING_STEPS of
them). An eager step's device times include the time the card waited
for the host to launch its work; a replay's hold none of that.

With obs.disable() `update()` is a shared no-op: no mark is made, and a
graph captured then holds no mark's kernel (GraphedLoop's signature
holds the switch, so toggling it captures again).

Profiler ranges. Importing this module sets obs.Tracer.range_hook:
while torch's profiler runs, every obs span also opens a
torch.profiler.record_function range of its own name, entered and left
on the span's thread. The program's spans are then host ranges on the
device trace's clock. A profiler records the thread that started it
(every thread with profile_all_threads, as the estimator's own
params["profiling"] trace asks where torch has it). With no profiler
running the hook costs one check of torch's own flag.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import time
from typing import Callable, List, Optional

import torch

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.obs.trace import Tracer

PHASES = ("sample", "forward", "backward", "optimizer")
# marks a model may make inside its forward, in this order
FORWARD_PHASES = ("gather", "breadth", "depth")
_MARKS = ("start",) + PHASES + FORWARD_PHASES
# eager steps kept for the next read; older ones fall off (a loop that
# never logs)
PENDING_STEPS = 4096

_local = threading.local()
_profiler = torch.autograd.profiler


def mark(phase: str) -> None:
    """The end of `phase` in the update open on this thread; nothing
    outside an update."""
    step = getattr(_local, "step", None)
    if step is not None:
        step.mark(phase)


class _Step:
    """One update's marks: [(phase, stamp)], the start first. On the
    card a stamp is the slot of `times`, which the mark's kernel fills,
    and `done` an event recorded after the step (an eager one)."""

    __slots__ = ("marks", "times", "done", "_stamp")

    def __init__(self, rec: "PhaseRecorder"):
        self.times = self.done = None
        self._stamp = rec._stamp
        self.marks = []
        if rec._cuda:
            self.times = torch.empty(len(_MARKS), dtype=torch.int64,
                                     device=rec._device)
        self.mark("start")

    def mark(self, phase: str) -> None:
        if phase not in _MARKS:
            # a card's mark writes a slot of `times`, sized for these
            raise ValueError(f"unknown phase {phase!r}")
        if all(p != phase for p, _ in self.marks):
            self.marks.append((phase, self._stamp(self)))



class _Update:
    __slots__ = ("_rec", "_step", "_prev")

    def __init__(self, rec: "PhaseRecorder"):
        self._rec = rec

    def __enter__(self):
        self._prev = getattr(_local, "step", None)
        self._step = _Step(self._rec)
        _local.step = self._step
        return self

    def __exit__(self, *exc):
        _local.step = self._prev
        self._rec._close(self._step)
        return False


@functools.lru_cache(maxsize=None)
def _timer_fn():
    from euler_tpu_torch.kernels import _build

    fn = _build.load("globaltimer").globaltimer_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class PhaseRecorder:
    """The phase marks of one estimator's updates and their reads.
    hist(phase) gives the histogram child a phase's milliseconds go to:
    made at once for PHASES, at a phase's first read for FORWARD_PHASES."""

    def __init__(self, device: torch.device, hist: Callable[[str], object]):
        self._device = device
        self._cuda = device.type == "cuda"
        self._new_hist = hist
        self._hist = {p: hist(p) for p in PHASES}
        self._pending = collections.deque(maxlen=PENDING_STEPS)
        self._replayed: List[_Step] = []
        self._replay_done = None
        self._captured: Optional[List[_Step]] = None

    def update(self):
        """Context manager around one update: its start mark, and the
        update made current for mark() on this thread."""
        if not _obs.enabled():
            return contextlib.nullcontext()
        return _Update(self)

    @contextlib.contextmanager
    def capture(self):
        """Around a CUDA graph's capture: yields the list that the
        captured updates' steps go to, whose marks each replay writes
        again (pass it to replayed())."""
        self._captured = steps = []
        try:
            yield steps
        finally:
            self._captured = None

    def replayed(self, steps: List[_Step]) -> None:
        """A replay of a graph whose capture gave `steps` was launched
        on the current stream: its marks are the ones the next read
        takes (a replay before it that no read took is lost)."""
        self._replayed = steps
        if steps:
            self._replay_done = self._event()

    def _event(self):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def _stamp(self, step: _Step):
        if not self._cuda:
            return time.perf_counter()
        slot = len(step.marks)
        rc = _timer_fn()(step.times.data_ptr(), slot,
                         torch.cuda.current_stream(self._device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"globaltimer kernel launch failed: CUDA "
                               f"error {rc}")
        return slot

    def _close(self, step: _Step) -> None:
        if self._captured is not None:
            self._captured.append(step)
            return
        if self._cuda:
            step.done = self._event()
        self._pending.append(step)

    def collect(self) -> int:
        """Observe the phases of every step whose marks have completed;
        never waits for the card. Returns the steps read."""
        ready = []
        while self._pending and (self._pending[0].done is None
                                 or self._pending[0].done.query()):
            ready.append(self._pending.popleft())
        if self._replayed and self._replay_done.query():
            ready += self._replayed
            self._replayed = []
        if not ready:
            return 0
        if self._cuda:
            # one copy of every buffer: the read is in the host's bubble
            # after a sync, where the card waits for the next launch
            ns = torch.stack([s.times for s in ready]).tolist()
            ms = [[row[i] / 1e6 for _, i in s.marks]
                  for s, row in zip(ready, ns)]
        else:
            ms = [[1000.0 * t for _, t in s.marks] for s in ready]
        for step, t in zip(ready, ms):
            for (phase, _), a, b in zip(step.marks[1:], t, t[1:]):
                hist = self._hist.get(phase)
                if hist is None:
                    hist = self._hist[phase] = self._new_hist(phase)
                hist.observe(b - a)
        return len(ready)


def _profiler_range(name: str):
    """A record_function range of `name` while torch's profiler runs,
    else None."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return None


if hasattr(_profiler, "_is_profiler_enabled"):
    Tracer.range_hook = staticmethod(_profiler_range)
