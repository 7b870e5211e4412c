"""A checkout of the benchmark at a size the CPU holds, for the tests.

make_root(tmp) copies gnnbench/ into tmp, adds the tiny configurations
of tests/data and a cell on each, and writes a BENCHMARK.json naming
them with every metric of the repository's BENCHMARK.json. run_in(root,
code) runs Python in a fresh process with that root first on the path
and the repository (the program) after it, so the copy's modules are
the ones imported.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CELLS = {"tiny_sage.uniform": ("tiny_sage", "train"),
         "tiny_unsup.uniform": ("tiny_unsup", "all")}
# set from CPU readings of the tiny cells over 12 seeds (PERF.md, the
# check): sound runs read at most 8.5e-8 (loss), 9.9e-8 (moment) and
# 1.1e-7 (change), the first step's loss 0; the planted faults at least
# 1.6e-4, 1.2e-2 (the widest loss), 4.2e-2 and 2.6e-2
LIMITS = {"picks_mismatch": 0, "mean_ulp_excess": 0, "loss_gap_first": 1e-5,
          "loss_gap": 1e-4, "moment_gap": 1e-4, "change_gap": 1e-4}


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "gnnbench", root / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for cell, (config, roots) in CELLS.items():
        shutil.copy(DATA / f"{config}.json",
                    root / "gnnbench" / "configs" / f"{config}.json")
        wl = {"why": "tiny", "roots": roots, "edge_weights": "unit",
              "batch_size": 64,
              "steps_per_loop": 4, "prefetch_depth": 8, "log_steps": 8,
              "trace_windows": 2,
              "limits": LIMITS}
        (root / "gnnbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(wl))
        bench["configs"].append({
            "name": config, "source": "tests", "reduced": [], "why": "tiny",
            "file": f"gnnbench/configs/{config}.json"})
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": "uniform", "chips": 1,
                                   "why": "tiny"})
    cells = list(CELLS)
    for m in bench["per_layer"]:
        m["workloads"] = cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_in(root: Path, code: str, timeout: float = 600) -> str:
    """Run code in a fresh interpreter at root; its standard output."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return proc.stdout


def run_cell_code(cell: str, seed: int, trace: int = 0,
                  plant: str = "") -> str:
    """Code that plants `plant` (Python run first), runs one CPU run of
    the cell and prints its result line and the forbidden modules."""
    return f"""
import json
{plant}
from pathlib import Path
from gnnbench import run
out = run.run_cell(Path('.'), {cell!r}, {seed}, 0.5, {bool(trace)}, device='cpu')
print(json.dumps(out))
print(json.dumps(run.forbidden_modules()))
"""
