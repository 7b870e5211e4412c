"""The reduction of a torch.profiler trace to device time.

Busy time is the union of the device's operation intervals (kernels,
copies and sets), not their sum: two streams' overlapping kernels count
once. An idle gap is a stretch between two busy intervals; it is named
after the innermost host operation that covers its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[float, float, str]  # start us, end us, name


def split_events(events) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host intervals) from a profiler's events()
    (FunctionEvents; times in microseconds)."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        item = (float(tr.start), float(tr.end), str(e.name))
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host.append(item)
        elif not getattr(e, "is_user_annotation", False):
            # a range's copy on the device's timeline is no operation
            dev.append(item)
    return dev, host


def busy_union(dev: List[Interval]) -> List[Tuple[float, float]]:
    """The merged busy intervals, in time order."""
    merged: List[List[float]] = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(dev: List[Interval]) -> float:
    return sum(e - s for s, e in busy_union(dev)) / 1e6


def top_ops(dev: List[Interval], n: int = 10) -> List[list]:
    """[[name, seconds]] of the n device operations that took most time,
    summed by name."""
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e6
    return [[k[:120], v] for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: List[Interval], host: List[Interval],
              window: Tuple[float, float], n: int = 10) -> List[list]:
    """[[host operation, seconds]] of the n longest idle gaps inside
    window (start us, end us), the edges of the window included."""
    gaps, t = [], window[0]
    for s, e in busy_union(dev):
        if s > t:
            gaps.append((t, min(s, window[1])))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        cover = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        name = min(cover)[1] if cover else "host: no profiled operation"
        out.append([name[:120], (e - s) / 1e6])
    return out


def mean_kernel_ms(dev: List[Interval], needle: str):
    """Mean duration in ms of the device operations whose name holds
    needle; None when there is none."""
    durs = [e - s for s, e, name in dev if needle in name]
    return sum(durs) / len(durs) / 1e3 if durs else None
