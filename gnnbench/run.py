#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card it is started on.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json, at the root of
the checkout. Everything about it is found by name, in files:
- its configuration: the file that BENCHMARK.json's `configs` entry
  names; its `family` key names the adapter gnnbench/models/<family>.py,
  whose plain reference is gnnbench/reference/<family>.py;
- its traffic: gnnbench/workloads/<cell>.json (sizes, K, prefetch,
  the limits of the correctness check);
- each metric: the reader gnnbench/metrics/<metric>.py, whose read(record)
  gives the value, or None where the run has nothing to read.
With --trace 0 the line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics.

The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device (and breakdown with --trace 1), and
last `checks`, each number compared beside its limit; the same numbers
are the last lines of standard error. Without a CUDA card, or with
fewer cards than the cell asks for, or when jax, jaxlib, flax, optax or
the JAX package euler_tpu has been imported by the time the result is
due, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "euler_tpu")


def process_start() -> float:
    """time.monotonic() at the start of this process (the kernel's
    start time of the process, against the clock of boot)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.monotonic() - max(up - started, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_PROCESS = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_reader(root: Path, name: str):
    path = root / "gnnbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gnnbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones with
    trace off, its per-layer ones with trace on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_cell(root: Path, cell: str):
    """(BENCHMARK.json, the cell's configuration, its traffic, its
    family's adapter module), found by the cell's name."""
    bench = load_benchmark(root)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    wl = json.loads((root / "gnnbench" / "workloads" / f"{cell}.json")
                    .read_text())
    family = importlib.import_module(f"gnnbench.models.{cfg['family']}")
    return bench, cfg, wl, family


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of a cell: the result line's object."""
    bench, cfg, wl, family = load_cell(root, cell)
    ctx = SimpleNamespace(cfg=cfg, workload=wl, seed=seed, seconds=seconds,
                          trace=trace, device=device,
                          process_start=T_PROCESS)
    rec = family.run(ctx)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": rec["device"]}
    if trace and "breakdown" in rec:
        out["breakdown"] = rec["breakdown"]
    out["checks"] = rec["checks"]
    print("seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rec.get("setup_parts", {}).items()),
        file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the build and kernel caches live in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    bench = load_benchmark(ROOT)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(entry["chips"]):
        print(f"the cell needs {entry['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules the benchmark must not load were imported: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
