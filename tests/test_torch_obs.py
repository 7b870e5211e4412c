"""The port's copies of the stdlib-only obs package and feeder
(euler_tpu_torch/obs/, euler_tpu_torch/estimator/prefetch.py) pinned to
the originals (euler_tpu/obs/, euler_tpu/estimator/prefetch.py): the same
operations give the same snapshot(), Prometheus text, span tree, health
snapshot and delivery order; and the retry rule (estimator/retry.py)
pinned to euler_tpu/graph/remote.py's."""

import threading

import pytest

from euler_tpu import obs as ref_obs
from euler_tpu.estimator import prefetch as ref_prefetch
from euler_tpu.obs import metrics as ref_metrics
from euler_tpu_torch import obs
from euler_tpu_torch.estimator import prefetch
from euler_tpu_torch.obs import metrics

PAIRS = [(ref_obs, ref_metrics), (obs, metrics)]


def test_module_api_is_the_reference_api():
    assert obs.__all__ == ref_obs.__all__
    assert metrics.__all__ == ref_metrics.__all__
    assert metrics.log2_buckets() == ref_metrics.log2_buckets()
    assert metrics.log2_buckets(0.5, 7) == ref_metrics.log2_buckets(0.5, 7)
    assert obs.DEFAULT_MS_BUCKETS == ref_obs.DEFAULT_MS_BUCKETS


def _drive_registry(pkg, met):
    reg = pkg.Registry()
    c = reg.counter("events_total", "events", ("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(2.5)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("wait_ms", "wait", ("stage",),
                      buckets=met.log2_buckets(0.25, 8))
    for v in (0.1, 0.25, 0.3, 1.0, 7.0, 1e6):
        h.labels(stage="x").observe(v)
    before = reg.snapshot()
    c.labels(kind="a").inc(3)
    h.labels(stage="y").observe(2.0)
    after = reg.snapshot()
    quantiles = [h.labels(stage="x").quantile(q) for q in (0.5, 0.9, 1.0)]
    return (after, met.snapshot_delta(before, after),
            reg.render_prometheus(), quantiles,
            met.bucket_quantile([1, 2, 3, 0], (1.0, 2.0, 4.0), 0.5))


def test_registry_copy_matches_the_reference():
    ref, got = (_drive_registry(*p) for p in PAIRS)
    assert got == ref


def _span_tree(pkg):
    tr = pkg.Tracer()
    with tr.span("train_step", step=1):
        with tr.span("input_wait", estimator="e0"):
            pass
        with tr.span("device_step") as sp:
            sp.set(note="x")
    tr.enabled = False
    with tr.span("dropped"):
        pass
    trace = tr.chrome_trace()
    ids = {e["args"]["span_id"]: e["name"] for e in trace["traceEvents"]}
    return sorted((e["name"], ids.get(e["args"]["parent_id"]),
                   sorted(k for k in e["args"]
                          if k not in ("span_id", "parent_id", "trace_id")),
                   e["ph"], e["cat"])
                  for e in trace["traceEvents"])


def test_tracer_copy_matches_the_reference(tmp_path):
    assert _span_tree(obs) == _span_tree(ref_obs)
    obs.reset_for_tests()  # the reference's registry is left as it is
    for pkg in (ref_obs, obs):
        hist = pkg.histogram("pin_phase_ms")
        with pytest.raises(StopIteration):
            with pkg.timed_span("input_wait", hist):
                raise StopIteration
        pkg.disable()
        assert pkg.span("off") is pkg.span("off2")  # the shared no-op
        pkg.enable()
        assert pkg.enabled()
        out = pkg.dump_trace(str(tmp_path / f"{pkg.__name__}.json"))
        assert out.endswith(".json")
        assert pkg.snapshot()["pin_phase_ms"]["values"][""]["count"] == 1


def test_health_registry_copy_matches_the_reference():
    class Provider:
        def health(self):
            return {"ok": 1}

    snaps = []
    for pkg in (ref_obs, obs):
        p = Provider()
        pkg.register_health("pin_provider", p.health)
        pkg.register_health("pin_broken", lambda: 1 / 0)
        snap = pkg.health_snapshot()
        snaps.append({k: snap[k] for k in ("pin_provider", "pin_broken")})
        del p  # weakly held: the provider drops off
        assert "pin_provider" not in pkg.health_snapshot()
        pkg.unregister_health("pin_broken")
    assert snaps[0] == snaps[1]


def _delivery(mod, workers):
    def source():
        for i in range(12):
            yield ("err" if i == 5 else "ok", i)

    def unpack(item):
        if item[0] == "err":
            raise ValueError(f"batch {item[1]}")
        return item[1]

    out = []
    with mod.make_feeder(source(), workers=workers, depth=3,
                         transform=unpack) as f:
        while True:
            try:
                out.append(next(f))
            except StopIteration:
                break
            except ValueError as e:
                out.append(str(e))
                if workers <= 1:  # the single-thread feeder ends there
                    break
    return out


@pytest.mark.parametrize("workers", [0, 3])
def test_feeder_copy_delivers_in_the_reference_order(workers):
    before = threading.active_count()
    ref = _delivery(ref_prefetch, workers)
    got = _delivery(prefetch, workers)
    assert got == ref
    if workers > 1:
        # a raised batch is delivered at its position and the stream
        # goes on (resilient)
        assert got == [0, 1, 2, 3, 4, "batch 5", 6, 7, 8, 9, 10, 11]
        assert prefetch.ParallelPrefetcher.resilient is True
    else:
        assert got == [0, 1, 2, 3, 4, "batch 5"]
    assert threading.active_count() <= before  # closed feeders end


def test_retry_rule_copy_matches_the_reference():
    """estimator/retry.py against euler_tpu/graph/remote.py: the same
    transport markers, and the same verdict on every non-engine error
    (the port has no EngineError yet)."""
    from euler_tpu.graph import remote
    from euler_tpu_torch.estimator import retry

    assert retry.TRANSPORT_MARKERS == remote._TRANSPORT_MARKERS
    for exc in (ConnectionError("reset"), ConnectionResetError(),
                TimeoutError(), OSError("disk"), ValueError("bad"),
                RuntimeError("failed after retries"), KeyError("x")):
        assert retry.retryable_error(exc) == remote.retryable_error(exc)
