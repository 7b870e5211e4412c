"""euler_tpu_torch.obs: unified metrics + tracing for every layer.

Copy of euler_tpu/obs/__init__.py and its modules (stdlib only; the
port imports nothing of euler_tpu); tests/test_torch_obs.py pins the
copies to the originals.

One dependency-free (stdlib-only) subsystem answering "where did this
step's milliseconds go?" across the whole stack — host sampling, RPC
wait, retry sleep, device dispatch — instead of the per-layer ad-hoc
surfaces (`RemoteGraphEngine.health()`, `BaseEstimator.health()`,
`Query.stats()`, hand-rolled time deltas) it unifies:

  metrics.py   Counter / Gauge / Histogram on a thread-safe Registry;
               labeled children, plain-dict snapshot(), Prometheus text
  trace.py     span("name", **attrs) context managers with per-thread
               parenting, a bounded ring of finished spans, and a
               chrome://tracing JSON exporter
  server.py    obs.serve(port): /metrics + /healthz on a stdlib
               http.server daemon thread

Module-level convenience API (the process-global default registry and
tracer — what the wired layers use)::

    from euler_tpu_torch import obs

    obs.counter("my_events_total").inc()
    with obs.span("load", shard=3):
        ...
    obs.dump_trace("run.json")        # → chrome://tracing / Perfetto
    srv = obs.serve(port=9464)        # scrape http://127.0.0.1:9464/metrics

In the port the estimator is wired (`estimator/base_estimator.py`:
per-step `train_step` → `input_wait` / `device_step` / `hook` phase
spans and histograms, the input-path counters behind `input_health`
and `health()`) and the feeder (`estimator/prefetch.py`:
`feeder_queue_depth`, `feeder_batches_total`).

`obs.disable()` turns the span path into a shared no-op;
counters stay live — they are the health() bookkeeping.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from euler_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    log2_buckets,
    snapshot_delta,
)
from euler_tpu_torch.obs.server import (  # noqa: F401
    ObsServer,
    health_snapshot,
    register_health,
    unregister_health,
)
from euler_tpu_torch.obs.trace import NULL_SPAN, Span, Tracer  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Tracer", "Span",
    "ObsServer", "default_registry", "default_tracer", "counter", "gauge",
    "histogram", "span", "timed_span", "serve", "snapshot",
    "snapshot_delta", "render_prometheus", "dump_trace", "clear_trace",
    "enable", "disable", "enabled", "register_health",
    "unregister_health", "health_snapshot", "log2_buckets",
    "DEFAULT_MS_BUCKETS", "reset_for_tests",
]

_mu = threading.Lock()
_registry: Optional[Registry] = None
_tracer: Optional[Tracer] = None
_enabled = True


def default_registry() -> Registry:
    """The process-global registry every wired layer reports into."""
    global _registry
    with _mu:
        if _registry is None:
            _registry = Registry()
        return _registry


def default_tracer() -> Tracer:
    """The process-global tracer behind obs.span()."""
    global _tracer
    with _mu:
        if _tracer is None:
            _tracer = Tracer()
        return _tracer


# -- metrics shorthands (default registry) --------------------------------
def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return default_registry().counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return default_registry().gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              buckets=None) -> Histogram:
    return default_registry().histogram(name, help, labelnames, buckets)


def snapshot() -> dict:
    """Plain-dict (JSON-safe) view of the default registry."""
    return default_registry().snapshot()


def render_prometheus() -> str:
    return default_registry().render_prometheus()


# -- tracing shorthands (default tracer) ----------------------------------
def span(name: str, **attrs):
    """Context manager timing a named interval on the default tracer.
    A shared no-op when tracing is disabled (obs.disable())."""
    if not _enabled:
        return NULL_SPAN
    return default_tracer().span(name, **attrs)


class _TimedSpan:
    """Span + millisecond-histogram observation in one context manager
    (the wired layers' shared timing idiom: estimator phases, graph rpc
    calls). Class-based — never a @contextmanager — so exceptions,
    including StopIteration, propagate untouched; the histogram is
    observed on BOTH the success and the raise path. __enter__ returns
    the span so callers can sp.set(...) attributes mid-flight."""

    __slots__ = ("_sp", "_hist", "_t0")

    def __init__(self, sp, hist):
        self._sp = sp
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        self._sp.__enter__()
        return self._sp

    def __exit__(self, *exc):
        self._sp.__exit__(*exc)
        self._hist.observe((time.monotonic() - self._t0) * 1000.0)
        return False


def timed_span(name: str, hist, **attrs) -> _TimedSpan:
    """`with obs.timed_span("phase", hist_ms, **attrs) as sp:` — a span
    on the default tracer whose wall time also lands in `hist` (in ms),
    success or raise."""
    return _TimedSpan(span(name, **attrs), hist)


def dump_trace(path: str) -> str:
    """Export the default tracer's span ring as chrome://tracing JSON."""
    return default_tracer().export(path)


def clear_trace() -> None:
    """Drop all finished spans (start of a measured region)."""
    default_tracer().clear()


# -- global switch ---------------------------------------------------------
def enable() -> None:
    """(Re-)enable span recording (the default)."""
    global _enabled
    _enabled = True
    default_tracer().enabled = True


def disable() -> None:
    """Disable span recording: obs.span() returns a shared no-op.
    Counters/gauges stay live — health() compat views and /metrics
    depend on them."""
    global _enabled
    _enabled = False
    default_tracer().enabled = False


def enabled() -> bool:
    return _enabled


# -- serving ---------------------------------------------------------------
def serve(port: int = 0, registry: Optional[Registry] = None,
          addr: str = "127.0.0.1") -> ObsServer:
    """Start the /metrics + /healthz endpoint (daemon thread). port=0
    picks an ephemeral port — read srv.port; srv.close() shuts down
    cleanly (no leaked thread, port freed)."""
    return ObsServer(port=port, registry=registry, addr=addr)


def reset_for_tests() -> None:
    """Fresh default registry + tracer (hermetic tests only — production
    code must never drop live counters out from under health() views)."""
    global _registry, _tracer, _enabled
    with _mu:
        _registry = Registry()
        _tracer = Tracer()
        _enabled = True
