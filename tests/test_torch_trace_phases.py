"""The port's train loop traced from inside (euler_tpu_torch/obs/device.py
and its wiring): the phase marks of an update and their reads, the
K-step window's root span, the replay's and the feeder's spans, and the
obs spans as torch.profiler ranges. On the CPU; the cases marked `cuda`
run the K-step CUDA graph on the card (`python -m pytest --noconftest -m
cuda tests/test_torch_trace_phases.py`)."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import itertools
import json
import threading

import numpy as np
import pytest
import torch

from euler_tpu_torch import obs
from euler_tpu_torch.dataset.synthetic import synthetic_citation
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.graphed_loop import GraphedLoop
from euler_tpu_torch.estimator.prefetch import (
    ParallelPrefetcher, Prefetcher,
)
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledUnsupervisedSage,
)
from euler_tpu_torch.obs import device
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

N, D, DIM, FANOUTS, CLASSES, B = 200, 8, 8, (3, 2), 4, 16
_TABLES = {}


def _static(dev):
    """The tables of a small graph on `dev` (built once a device)."""
    if dev not in _TABLES:
        g = synthetic_citation(n=N, d=D, num_classes=CLASSES, seed=5,
                               train_per_class=5, val=10, test=10)
        feats = np.concatenate([g.features, np.zeros((1, D), np.float32)])
        labels = np.concatenate([g.onehot_labels(),
                                 np.zeros((1, CLASSES), np.float32)])
        tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=8,
                                           device=dev)
        store = DeviceFeatureStore.from_arrays(feats, labels,
                                               quantize="int8", device=dev)
        neg = DeviceNodeSampler.from_arrays(np.ones(N, np.float32),
                                            device=dev)
        _TABLES[dev] = (tab.pad_row, {
            **tab.tables, **neg.tables, "feature_table": store.features,
            "feature_scale": store.feature_scale,
            "label_table": store.labels})
    return _TABLES[dev]


def _estimator(kind, dev="cpu", **params):
    pad_row, static = _static(dev)
    gen = torch.Generator().manual_seed(0)
    if kind == "supervised":
        model = DeviceSampledGraphSage(CLASSES, D, multilabel=False,
                                       dim=DIM, fanouts=FANOUTS,
                                       generator=gen)
    else:
        model = DeviceSampledUnsupervisedSage(pad_row, D, dim=DIM,
                                              fanouts=FANOUTS, num_negs=2,
                                              generator=gen)
    model_dir = params.pop("model_dir", None)
    est = BaseEstimator(model, {"checkpoint_steps": 0, "log_steps": 4,
                                **params}, device=dev, model_dir=model_dir)
    est.static_batch = static
    return est


def _batches(count, size=B):
    rng = np.random.default_rng(3)
    return [{"rows": [torch.from_numpy(
        rng.integers(0, N, size).astype(np.int32))], "sample_seed": i + 1}
        for i in range(count)]


def _values(name, **labels):
    """{label values: the child's value} of a metric in the default
    registry, the children whose labels hold `labels`."""
    snap = obs.snapshot().get(name, {}).get("values", {})
    want = {f"{k}={v}" for k, v in labels.items()}
    return {k: v for k, v in snap.items() if want <= set(k.split(","))}


def _phases(est):
    return {k.split("phase=")[1]: v for k, v in _values(
        "estimator_phase_device_ms", estimator=est._obs_name).items()}


@pytest.mark.parametrize("kind,k", [("supervised", 4), ("supervised", 1),
                                    ("unsupervised", 4)])
def test_every_phase_is_observed_once_a_step(kind, k):
    """A CPU estimator reads every step's four phases (K = 4: two
    windows of eager steps; K = 1: single steps), and on the CPU, where
    a step is synchronous, their sums make up the device_step
    histogram's within 20%."""
    est = _estimator(kind, steps_per_loop=k)
    est.train(iter(_batches(8)), max_steps=8)
    phases = _phases(est)
    assert sorted(phases) == sorted(device.PHASES)
    assert {v["count"] for v in phases.values()} == {8}
    dispatch = _values("estimator_device_step_ms",
                       estimator=est._obs_name)
    total = sum(v["sum"] for v in dispatch.values())
    assert sum(v["sum"] for v in phases.values()) == pytest.approx(
        total, rel=0.2)


def test_disabled_obs_marks_nothing():
    """With obs.disable() no phase is observed and no span recorded."""
    est = _estimator("supervised", steps_per_loop=4)
    obs.clear_trace()
    obs.disable()
    try:
        est.train(iter(_batches(8)), max_steps=8)
        recorded = len(obs.default_tracer())
    finally:
        obs.enable()
    assert all(v["count"] == 0 for v in _phases(est).values())
    assert recorded == 0


def test_marks_outside_an_update_and_repeated_marks():
    """A mark with no update open records nothing; a phase's repeated
    mark is ignored; a model that draws nothing of its own has its
    forward from the start."""
    hist = obs.default_registry().histogram(
        "test_phase_ms", "", ("phase",))
    rec = device.PhaseRecorder(torch.device("cpu"),
                               lambda p: hist.labels(phase=p))
    device.mark("forward")
    with rec.update():
        device.mark("forward")
        device.mark("forward")
        device.mark("optimizer")
    with rec.update():
        device.mark("sample")
    device.mark("optimizer")
    assert rec.collect() == 2
    counts = {p: hist.labels(phase=p).value["count"]
              for p in device.PHASES}
    assert counts == {"sample": 1, "forward": 1, "backward": 0,
                      "optimizer": 1}


def test_the_window_is_one_trace():
    """K = 4: each window's input_wait, device_step and hook spans sit
    under one train_window root span and share its trace id; the wait
    for train()'s first batch comes before any window."""
    est = _estimator("supervised", steps_per_loop=4)
    obs.clear_trace()
    est.train(iter(_batches(8)), max_steps=8)
    spans = sorted(obs.default_tracer().spans(), key=lambda s: s.ts_us)
    roots = {s.span_id: s for s in spans if s.name == "train_window"}
    assert len(roots) == 2 and all(s.parent_id == 0
                                   for s in roots.values())
    inner = [s for s in spans
             if s.name in ("input_wait", "device_step", "hook")]
    assert inner[0].name == "input_wait" and inner[0].parent_id == 0
    assert [s.name for s in inner[1:]] == [
        "input_wait", "device_step", "hook"] * 2
    for s in inner[1:]:
        assert s.trace_id == roots[s.parent_id].trace_id


def test_the_obs_switch_is_part_of_the_graphs_signature():
    """Toggling obs changes what the K-step graph depends on, so the
    graph is captured again without (or with) the phase marks."""
    est = _estimator("supervised")
    loop = object.__new__(GraphedLoop)
    batches = [{"rows": [b["rows"][0]], "sample_seed": 1}
               for b in _batches(2)]
    on = loop._signature(est, batches)
    obs.disable()
    try:
        off = loop._signature(est, batches)
    finally:
        obs.enable()
    assert on != off and on[:3] == off[:3]


def _source():
    for i in itertools.count():
        yield {"i": i}


@pytest.mark.parametrize("feeder", ["prefetcher", "parallel"])
def test_the_feeder_times_each_batch_on_its_thread(feeder):
    """Each batch a feeder makes is one feeder_source span and one
    feeder_transform span, both on a feeder thread, each observed in its
    histogram under the feeder's name."""
    obs.clear_trace()

    def transform(b):
        return {**b, "moved": True}

    if feeder == "prefetcher":
        f = Prefetcher(_source(), depth=2, transform=transform)
        threads = [f._thread]
        name = f._times._name
    else:
        f = ParallelPrefetcher(_source(), workers=2, depth=2,
                               transform=transform)
        threads = f._threads
        name = f._name
    got = [next(f)["moved"] for _ in range(5)]
    f.close()
    assert got == [True] * 5
    spans = obs.default_tracer().spans()
    tids = {t.ident for t in threads}
    source = [s for s in spans if s.name == "feeder_source"]
    moved = [s for s in spans if s.name == "feeder_transform"]
    assert len(source) == len(moved) >= 5
    assert {s.tid for s in source + moved} <= tids
    assert threading.get_ident() not in tids
    for hist in ("feeder_source_ms", "feeder_transform_ms"):
        assert _values(hist, feeder=name)[f"feeder={name}"]["count"] \
            == len(source)


def test_spans_are_profiler_ranges_only_under_a_profiler(tmp_path,
                                                         monkeypatch):
    """Without a profiler no span enters a record_function range. Under
    torch.profiler the loop's spans are host ranges of the profiling
    thread; the estimator's own params["profiling"] trace, over every
    thread, also holds the feeder's."""
    entered = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    est = _estimator("supervised", steps_per_loop=4)
    est.train(iter(_batches(8)), max_steps=8)
    loop = {"train_window", "input_wait", "device_step", "hook"}
    assert not loop & set(entered)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        est.train(iter(_batches(8)), max_steps=16)
    assert loop <= {e.name for e in prof.events()}
    est = _estimator("supervised", steps_per_loop=4, profiling=True,
                     model_dir=str(tmp_path))
    feed = Prefetcher(iter(_batches(8)), depth=2, transform=est._to_device)
    try:
        est.train(feed, max_steps=8)
    finally:
        feed.close()
    trace = json.loads(next((tmp_path / "prof").iterdir()).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"input_wait", "device_step", "feeder_source",
            "feeder_transform"} <= names


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["supervised", "unsupervised"])
def test_replay_phases_add_up_to_the_replay(card, kind):
    """K = 4 on the card, batches of 16,384 roots: the first window
    eager (each step read), then replays read at each log. The four
    phases of a replay add up to its device time, timed again by events
    around a replay of the same graph, within 10%."""
    est = _estimator(kind, "cuda", steps_per_loop=4)
    batches = [{"rows": [b["rows"][0].cuda()],
                "sample_seed": b["sample_seed"]}
               for b in _batches(16, 1 << 14)]
    est.train(iter(batches), max_steps=16)
    assert est._graphed.captures == 1 and est._graphed.replays == 3
    phases = _phases(est)
    # the eager window's 4 steps, then each replay (a log after each)
    assert {v["count"] for v in phases.values()} == {16}
    before = sum(v["sum"] for v in phases.values())
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    est._graphed.graph.replay()
    est._phases.replayed(est._graphed._phase_steps)
    stop.record()
    stop.synchronize()
    assert est._phases.collect() == 4
    replay_ms = start.elapsed_time(stop)
    got = sum(v["sum"] for v in _phases(est).values()) - before
    assert got == pytest.approx(replay_ms, rel=0.1)


@pytest.mark.cuda
def test_disabled_obs_captures_no_marks(card):
    """With obs.disable() the K-step graph is captured again and holds
    no mark: the phase histogram stays empty over its replays."""
    est = _estimator("supervised", "cuda", steps_per_loop=4)
    batches = [{"rows": [b["rows"][0].cuda()],
                "sample_seed": b["sample_seed"]} for b in _batches(24)]
    est.train(iter(batches[:8]), max_steps=8)
    counts = {p: v["count"] for p, v in _phases(est).items()}
    obs.disable()
    try:
        est.train(iter(batches[8:]), max_steps=24)
    finally:
        obs.enable()
    assert est._graphed.captures == 2
    assert {p: v["count"] for p, v in _phases(est).items()} == counts
    assert est._graphed._phase_steps == []
