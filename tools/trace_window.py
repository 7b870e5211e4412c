#!/usr/bin/env python3
"""One run of a gnnbench cell, as gnnbench/run.py makes it, with the
program's own spans and phase histograms read over each train() call.

    python3 tools/trace_window.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--obs off] [--out PATH]

For every BaseEstimator.train call of the run (the warm-up, the checked
replay, the timed window and, with --trace 1, the traced window) it
records the steps, the host seconds and the deltas (count, sum) of the
estimator's and the feeder's histograms. The timed window is the call
with the most steps; over it the line gives, per step, the device ms of
each phase of an update (estimator_phase_device_ms: sum / count of the
steps read; the genie encoder's forward phases too) and the host ms of
the replay's and the feeder's spans (sum / the window's steps), beside
the benchmark's result line. Each call also counts the host's launches
of ops/row_sparse_adam.py (an eager step launches once per row-sparse
table, a capture records one a step, a replay adds none). --obs off
runs the whole program with obs.disable(). The last line of standard
output is the JSON record; --out writes it to a file too. Needs a CUDA
card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HISTOGRAMS = ("estimator_phase_device_ms", "estimator_device_step_ms",
              "estimator_input_wait_ms", "estimator_hook_ms",
              "estimator_replay_stage_ms", "estimator_replay_launch_ms",
              "feeder_source_ms", "feeder_transform_ms")


def _sums(snap: dict) -> dict:
    """{histogram (phase histograms by phase): [count, sum]}."""
    out = {}
    for name in HISTOGRAMS:
        for labels, v in snap.get(name, {}).get("values", {}).items():
            key = name
            if "phase=" in labels:
                key += "." + labels.split("phase=")[1].split(",")[0]
            c, s = out.get(key, (0, 0.0))
            out[key] = (c + v["count"], s + v["sum"])
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: [c - before.get(k, (0, 0.0))[0],
                s - before.get(k, (0, 0.0))[1]]
            for k, (c, s) in after.items()}


def per_step(call: dict) -> dict:
    """Per-step ms over one train call: phases by the steps read, the
    host spans by the call's steps."""
    steps, d = call["steps"], call["histograms"]
    out = {}
    for k, (c, s) in d.items():
        if k.startswith("estimator_phase_device_ms."):
            out[k.split(".", 1)[1] + "_device_ms_per_step"] = \
                s / c if c else None
        elif steps:
            name = k.replace("estimator_", "").replace("_ms", "")
            out[name + "_ms_per_step"] = s / steps
    # the four phases of an update, and the forward's own where the model
    # marks them (the genie encoder's gather, breadth, depth)
    phases = [v for k, v in out.items() if k.endswith("_device_ms_per_step")]
    if phases and None not in phases:
        out["phases_device_ms_per_step"] = sum(phases)
    if steps:
        out["wall_ms_per_step"] = 1000.0 * call["seconds"] / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--obs", choices=("on", "off"), default="on")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    from gnnbench import run as bench

    from euler_tpu_torch import obs
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator
    from euler_tpu_torch.ops.row_sparse_adam import row_sparse_adam

    if args.obs == "off":
        obs.disable()
    calls = []
    train = BaseEstimator.train

    def traced_train(est, *a, **kw):
        reg = obs.default_registry()
        before, step0 = _sums(reg.snapshot(run_collectors=False)), est.step
        launches = row_sparse_adam.launches
        t0 = time.monotonic()
        try:
            return train(est, *a, **kw)
        finally:
            calls.append({
                "steps": est.step - step0,
                "seconds": time.monotonic() - t0,
                "row_sparse_adam_launches":
                    row_sparse_adam.launches - launches,
                "histograms": _delta(
                    before, _sums(reg.snapshot(run_collectors=False)))})

    BaseEstimator.train = traced_train
    out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    window = max(calls, key=lambda c: c["steps"])
    rec = {"workload": args.workload, "seed": args.seed,
           "obs": args.obs, "trace": args.trace, "result": out,
           "window": per_step(window),
           "calls": [dict(c, per_step=per_step(c)) for c in calls]}
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
