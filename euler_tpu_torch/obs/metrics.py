"""Thread-safe metrics: Counter / Gauge / Histogram on a Registry.

Copy of euler_tpu/obs/metrics.py (stdlib only; the port imports nothing
of euler_tpu). tests/test_torch_obs.py pins it to the original.

The metrics half of euler_tpu_torch.obs (see the package docstring for the
full map). Deliberately dependency-free — stdlib only — so every layer
of the stack (ctypes graph client, input pipeline, train loop, bench)
can instrument itself without import-order or optional-dep concerns.

Model (a small subset of the Prometheus client data model):

  * a Registry owns named metrics; names are unique per registry and a
    second registration with the same name must agree on kind and label
    names (get-or-create — wiring code in N instances shares one metric
    and distinguishes itself by label values);
  * each metric has zero or more LABEL NAMES; `metric.labels(a="x")`
    returns (creating on first use) the child holding the actual value
    for that label combination. Label-less metrics act as their own
    child (`counter.inc()` just works);
  * Histogram uses FIXED bucket bounds chosen at creation — default
    log-scale (powers of two) millisecond bounds — with Prometheus
    `le`-inclusive semantics and cumulative exposition;
  * `snapshot()` renders the whole registry to a plain, JSON-safe dict
    (bench artifacts embed it verbatim); `render_prometheus()` renders
    the text exposition format `obs.serve()` publishes on /metrics.

Collectors: `add_collector(fn)` registers a zero-arg callable invoked
before every snapshot/exposition — the bridge for engine-side counters
that live outside Python (gql.Query.stats(), the UDF result cache).
A collector that returns False is dropped (its source is gone); a
collector that raises is dropped too, with the failure counted on the
registry's own `obs_collector_errors_total`.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "log2_buckets",
           "DEFAULT_MS_BUCKETS", "snapshot_delta", "bucket_quantile"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_INF = float("inf")


def log2_buckets(lo: float = 0.001, count: int = 24) -> Tuple[float, ...]:
    """Fixed log-scale bucket bounds: lo, 2*lo, 4*lo, ... (`count` of
    them). The default (lo=1µs expressed in ms, 24 buckets) spans 1µs
    to ~8.4s — wide enough for a counter bump and a black-holed RPC on
    the same axis."""
    return tuple(lo * (2.0 ** i) for i in range(count))


DEFAULT_MS_BUCKETS = log2_buckets()


def bucket_quantile(counts, bounds, q: float) -> Optional[float]:
    """Bucket-interpolated quantile over RAW (non-cumulative) per-bucket
    counts — the Prometheus histogram_quantile convention: find the
    bucket holding the q-th observation and interpolate linearly inside
    its [lower, upper] bounds; the first bucket interpolates from 0 and
    the +Inf bucket clamps to the last finite bound. None when empty.
    `counts` may have one more entry than `bounds` (the overflow
    bucket). Shared by _HistogramChild.quantile and the native
    server-trace bridge (euler_tpu.gql.server_trace_hist)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    n = sum(counts)
    if n == 0:
        return None
    target = q * n
    cum = 0.0
    lower = 0.0
    for le, c in zip(bounds, counts):
        if cum + c >= target and c > 0:
            frac = (target - cum) / c
            return lower + (le - lower) * min(max(frac, 0.0), 1.0)
        cum += c
        lower = le
    # target lands in the overflow bucket: clamp to the last finite edge
    return float(bounds[-1])


def _fmt(v: float) -> str:
    """Exposition number format: integral values render as integers so
    golden-text tests and human eyes don't churn on '3.0' vs '3'."""
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


class _CounterChild:
    """Monotonic float accumulator (one label combination)."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._mu:
            self._v += n

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class _GaugeChild:
    """Settable value (one label combination)."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._mu:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._mu:
            self._v -= n

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class _HistogramChild:
    """Fixed-bound histogram (one label combination). `le`-inclusive
    bucket assignment, cumulative counts at exposition time."""

    __slots__ = ("_mu", "bounds", "_counts", "_sum", "_n")

    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self._mu = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # first bound >= v → v <= bound, the Prometheus `le` convention
        # (a value exactly ON a bucket edge lands in that bucket)
        i = bisect.bisect_left(self.bounds, v)
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def value(self) -> Dict:
        """{"count", "sum", "buckets": [[le, cumulative], ...]} with le
        "+Inf" on the last entry — plain data, JSON-safe."""
        with self._mu:
            counts = list(self._counts)
            s, n = self._sum, self._n
        out, cum = [], 0
        for le, c in zip(self.bounds, counts):
            cum += c
            out.append([le, cum])
        out.append(["+Inf", n])
        return {"count": n, "sum": s, "buckets": out}

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (the Prometheus
        histogram_quantile convention): find the bucket holding the
        q-th observation and interpolate linearly inside its [lower,
        upper] bounds, assuming observations are uniform within a
        bucket. The first bucket interpolates from 0; the +Inf bucket
        clamps to the last finite bound (an estimate cannot exceed what
        the buckets resolve). None when the histogram is empty.

        Exact for values ON bucket edges, within one bucket's width
        otherwise — good enough for adaptive hedge delays and p2c,
        which only need the tail's order of magnitude."""
        with self._mu:
            counts = list(self._counts)
        return bucket_quantile(counts, self.bounds, q)


class _Metric:
    """Shared label-family machinery. Subclasses set `kind` and
    `_child_cls`; label-less metrics proxy child methods directly."""

    kind = ""
    _child_cls = None

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._mu = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        return self._child_cls()

    def labels(self, **labels):
        """The child for this label-value combination (created on first
        use). Every label name declared at registration must be given."""
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._mu:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def remove(self, **labels) -> None:
        """Drop one child (label combination) from exposition. The child
        object itself stays valid for anyone still holding it — only the
        registry's view forgets it. For retiring a whole instance's
        series, see Registry.prune()."""
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._mu:
            self._children.pop(key, None)

    def _prune_label(self, labelname: str, value: str) -> None:
        if labelname not in self.labelnames:
            return
        i = self.labelnames.index(labelname)
        v = str(value)
        with self._mu:
            for key in [k for k in self._children if k[i] == v]:
                del self._children[key]

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; "
                "use .labels(...)")
        return self._children[()]

    @property
    def value(self):
        return self._default().value

    def _items(self):
        with self._mu:
            return list(self._children.items())

    def _snapshot_values(self) -> Dict[str, object]:
        return {
            ",".join(f"{ln}={lv}" for ln, lv in zip(self.labelnames, key)):
                child.value
            for key, child in self._items()
        }


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        bounds = tuple(sorted(float(b) for b in
                              (buckets if buckets is not None
                               else DEFAULT_MS_BUCKETS)))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile of the label-less child (see
        _HistogramChild.quantile); labeled histograms call
        .labels(...).quantile(q)."""
        return self._default().quantile(q)


def snapshot_delta(before: Dict, after: Dict) -> Dict:
    """Measured-region view of two snapshot() dicts: cumulative metrics
    (counters; histogram count/sum/buckets) report `after - before`,
    gauges report their `after` level (they are not accumulators).
    Children absent from `before` diff against zero — the bench uses
    this to attach the metrics of exactly the measured region next to
    the lifetime snapshot."""
    out = {}
    for name, m in after.items():
        kind = m["type"]
        b_vals = before.get(name, {}).get("values", {})
        vals = {}
        for key, av in m["values"].items():
            bv = b_vals.get(key)
            if kind == "gauge":
                vals[key] = av
            elif kind == "histogram":
                b_buckets = {tuple(x[:1]): x[1]
                             for x in (bv or {}).get("buckets", [])}
                vals[key] = {
                    "count": av["count"] - (bv or {}).get("count", 0),
                    "sum": av["sum"] - (bv or {}).get("sum", 0.0),
                    "buckets": [[le, cum - b_buckets.get((le,), 0)]
                                for le, cum in av["buckets"]],
                }
            else:
                vals[key] = av - (bv or 0)
        out[name] = {"type": kind, "help": m["help"], "values": vals}
    return out


class Registry:
    """Named-metric container + collector hooks. Thread-safe; cheap to
    construct (tests use throwaway instances, production code shares
    the process-global one from euler_tpu_torch.obs.default_registry())."""

    def __init__(self):
        self._mu = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: list = []

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help,
                                              labelnames=labelnames, **kw)
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"metric {name!r} registered with labels {m.labelnames}, "
                f"re-requested with {tuple(labelnames)}")
        want = kw.get("buckets")
        if want is not None:
            # a silently-dropped bucket spec would park every observe in
            # the wrong bounds with no signal — conflict must raise like
            # the kind/label mismatches above
            want = tuple(sorted(float(b) for b in want))
            if want != m.buckets:
                raise ValueError(
                    f"histogram {name!r} registered with buckets "
                    f"{m.buckets}, re-requested with {want}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._mu:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._mu:
            self._metrics.pop(name, None)

    def prune(self, labelname: str, value: str) -> None:
        """Drop every child across all metrics whose `labelname` label
        equals `value` — retires a dead instance's series (e.g.
        prune("estimator", "estimator7") in a sweep harness that builds
        thousands of estimators) so long-lived processes don't grow the
        scrape without bound. Deliberately NOT called automatically on
        close(): a closed engine's final counters staying visible until
        the operator retires them is the Prometheus convention."""
        with self._mu:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._prune_label(labelname, value)

    # -- collectors --------------------------------------------------------
    def add_collector(self, fn) -> None:
        """fn() runs before every snapshot/exposition. Return False to
        be dropped (source gone); raising drops the collector and bumps
        obs_collector_errors_total."""
        with self._mu:
            self._collectors.append(fn)

    def collect(self) -> None:
        with self._mu:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn() is False:
                    dead.append(fn)
            except Exception:
                dead.append(fn)
                self.counter(
                    "obs_collector_errors_total",
                    "collectors dropped after raising during scrape").inc()
        if dead:
            with self._mu:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]

    # -- export ------------------------------------------------------------
    def snapshot(self, run_collectors: bool = True) -> Dict:
        """Plain-dict view of every metric:
        {name: {"type", "help", "values": {"label=value,...": v}}} where
        v is a number (counter/gauge) or the histogram dict. JSON-safe —
        bench artifacts embed it verbatim."""
        if run_collectors:
            self.collect()
        with self._mu:
            metrics = sorted(self._metrics.items())
        return {name: {"type": m.kind, "help": m.help,
                       "values": m._snapshot_values()}
                for name, m in metrics}

    def render_prometheus(self, run_collectors: bool = True) -> str:
        """Prometheus text exposition format (text/plain version 0.0.4),
        metrics sorted by name, children in insertion order."""
        if run_collectors:
            self.collect()
        with self._mu:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, child in m._items():
                base = ",".join(
                    f'{ln}="{_escape_label(lv)}"'
                    for ln, lv in zip(m.labelnames, key))
                if m.kind == "histogram":
                    h = child.value
                    for le, cum in h["buckets"]:
                        le_s = "+Inf" if le == "+Inf" else _fmt(le)
                        sep = "," if base else ""
                        lines.append(
                            f'{name}_bucket{{{base}{sep}le="{le_s}"}} '
                            f'{cum}')
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{sfx} {_fmt(h['sum'])}")
                    lines.append(f"{name}_count{sfx} {h['count']}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{sfx} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"
