#!/usr/bin/env python3
"""The readings the limits of a cell's check are set from, on the card.

    python3 gnnbench/control.py --workload <cell> --seeds 11 12 13 \
        [--seconds 1] [--program-fault stale_inputs]

For each seed it makes one run of the cell as run.py does (a short
window) and prints every number the check can compare
(training.numbers), for:
- "program": the program against the plain reference in float32: the
  sound runs, whose largest readings are a limit's lower end;
- "tf32": the control, the reference computed one precision below the
  configuration's (TF32 for float32 with TF32 off), put in the
  program's place, against the reference in float32 (each on its own
  deepest means);
- the faults planted in the reference put in the program's place: half
  of the batch left out of the loss ("half_batch"), the picks altered
  where they are drawn ("altered_picks").
With --program-fault it plants a fault of the K-step graph's replay in
the program instead, and prints only its "program" line:
"stale_inputs" (a replay reads the batches of the capture, its static
inputs never refreshed), "frozen_seed" (the sampling generators not
seeded again for a replay's batches).
A state left unchanged reads 1 on the worst leaf's change and moment
by the check's measure and needs no run. Each reading is one JSON line
on standard output, beside the cell's limits and whether it fails
them. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = (("tf32", None), ("float32", "half_batch"),
            ("float32", "altered_picks"))


def plant(fault: str) -> None:
    """Break the K-step graph's replay as `fault` names."""
    from euler_tpu_torch.estimator import graphed_loop as gl

    if fault == "stale_inputs":
        keys = gl.GraphedLoop._tensor_keys
        gl.GraphedLoop._tensor_keys = lambda self, batch: (
            [] if self.graph is not None else keys(self, batch))
    elif fault == "frozen_seed":
        gl.GraphedLoop._seed = lambda self, est, batches: None
    else:
        raise ValueError(f"unknown fault {fault!r}")


def readings(root: Path, cell: str, seed: int, device: str = "cuda",
             variants=VARIANTS, seconds: float = 1.0,
             program_fault: str = ""):
    """[(variant, numbers, fails)] for one seed: the program's run first,
    then each variant of the reference in its place."""
    from gnnbench import run as harness
    from gnnbench import training

    _, cfg, wl, family = harness.load_cell(root, cell)
    if program_fault:
        plant(program_fault)
    ctx = SimpleNamespace(cfg=cfg, workload=wl, seed=seed, seconds=seconds,
                          trace=False, device=device,
                          process_start=harness.T_PROCESS)
    rec = training.run(ctx, family)
    out = [(program_fault or "program", rec["numbers"], not rec["correct"])]
    if program_fault or not variants:
        return out
    base, *others = training.reference_runs(
        family, cfg, rec["seeds"], rec["kept"], training.torch.device(device),
        (("float32", None),) + tuple(variants), keep_picks=True)
    for (precision, fault), obs in zip(variants, others):
        obs["picks_mismatch"] = sum(training.count_mismatch(a, b) for a, b
                                    in zip(obs["picks"], base["picks"]))
        values = training.numbers(obs, base)
        correct, _ = training.judge(values, wl["limits"])
        out.append((fault or precision, values, not correct))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--program-fault", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        for variant, values, fails in readings(
                ROOT, args.workload, seed, args.device,
                seconds=args.seconds, program_fault=args.program_fault):
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "variant": variant, "numbers": values,
                              "fails_limits": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
