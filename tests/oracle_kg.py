"""The JAX package's own knowledge-graph runs over seeds, the oracle of
the port's quality gates for the relational slice (chip_smoke.py's
slice-11 quality phase, PERF.md):

    JAX_PLATFORMS=cpu EULER_TPU_PLATFORM=cpu python tests/oracle_kg.py \\
        transe [--seeds 0 1 ... 9]

runs the reference runner with its defaults on the fb15k237 stand-in
(the runners' default dataset; RESULTS.md names the rows "fb15k"), once
per --seeds value: transe, transh, transr, transd
(`examples/TransX/run_transx.py --model <name>`), distmult
(`examples/distmult/run_distmult.py`) and rgcn (`examples/rgcn/
run_rgcn.py`); the metric is the eval MRR of the true tail among its
corruptions. The reference's runners take no seed: each run here seeds
the engine's sampler with the seed, sets params["seed"] to it in
BaseEstimator (the init key) and, from that constructor on, makes the
runner's `np.random.default_rng(0)` (its negatives and, in rgcn, its
relation draws) a default_rng(seed), as the port's --seed moves the
engine's draws, the init and that stream. The dataset's own draws
(load_kg's default_rng(0), made before the estimator) stay as they are.
Nothing in euler_tpu/ or examples/ is edited: the constructor and
numpy's default_rng are wrapped while the script runs. It prints each
run's metric, their mean, standard deviation and standard error.
--port runs the port's runner instead (euler_tpu_torch.examples, the
same flags plus --device cpu --seed <seed>), whose spread over seeds
enters the gates' standard error. Not a test: pytest does not collect
it.

Results on the CPU, seeds 0-9, are TEN_SEED and PORT_SD below;
chip_smoke.py's quality gates read them.
"""

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# runner → (reference script, argv, the port's module)
RUNNERS = {
    "transe": ("TransX/run_transx.py", ["--model", "TransE"], "run_transx"),
    "transh": ("TransX/run_transx.py", ["--model", "TransH"], "run_transx"),
    "transr": ("TransX/run_transx.py", ["--model", "TransR"], "run_transx"),
    "transd": ("TransX/run_transx.py", ["--model", "TransD"], "run_transx"),
    "distmult": ("distmult/run_distmult.py", [], "run_distmult"),
    "rgcn": ("rgcn/run_rgcn.py", [], "run_rgcn"),
}

# the reference's 10-seed results (seeds 0-9, this script on the CPU):
# runner → (mean, standard deviation over the seeds)
TEN_SEED = {
    "transe": (0.9082969155907632, 0.0038159688430137993),
    "transh": (0.9074054181575775, 0.003935244749125708),
    "transr": (0.8477781865000725, 0.003599334875352416),
    "transd": (0.880577983558178, 0.004754954716786228),
    "distmult": (0.8959389129281045, 0.00411248186746437),
    "rgcn": (0.7168783777952195, 0.009326745188459253),
}
# the port's runners over the same seeds (--port, on the CPU): runner →
# standard deviation over the seeds
PORT_SD = {
    "transe": 0.00341552481896575,
    "transh": 0.004090804025678532,
    "transr": 0.003873866856014502,
    "transd": 0.004352946101148937,
    "distmult": 0.004036449467640646,
    "rgcn": 0.00926509762142109,
}


def _runner(rel: str):
    path = ROOT / "examples" / rel
    spec = importlib.util.spec_from_file_location(
        "ref_kg_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _summary(args, vals, **extra) -> None:
    out = {"runner": args.runner, **extra, "seeds": args.seeds,
           "metric": vals, "mean": statistics.fmean(vals)}
    if len(vals) > 1:
        out["sd"] = statistics.stdev(vals)
        out["se"] = out["sd"] / len(vals) ** 0.5
    print(json.dumps(out), flush=True)


@contextlib.contextmanager
def _seeded(s: int):
    """BaseEstimator with params["seed"] = s, and numpy's default_rng
    giving default_rng(s) from that constructor on."""
    import numpy as np

    from euler_tpu.estimator import base_estimator as B

    init, rng = B.BaseEstimator.__init__, np.random.default_rng

    def seeded(self, model, params, *a, **kw):
        init(self, model, {**params, "seed": s}, *a, **kw)
        np.random.default_rng = lambda *_, **__: rng(s)

    B.BaseEstimator.__init__ = seeded
    try:
        yield
    finally:
        B.BaseEstimator.__init__ = init
        np.random.default_rng = rng


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("runner", choices=sorted(RUNNERS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    rel, argv, port_mod = RUNNERS[args.runner]
    if args.port:
        return _port(args, argv, port_mod)
    run = _runner(rel)
    from euler_tpu.graph import seed

    vals = []
    for s in args.seeds:
        seed(s)
        with _seeded(s), contextlib.redirect_stdout(io.StringIO()):
            res = run.main([*argv, "--platform", "cpu"])
        vals.append(float(res["metric"]))
        print(f"seed {s}: metric {vals[-1]:.4f}", flush=True)
    _summary(args, vals)


def _port(args, argv, port_mod: str) -> None:
    sys.path.insert(0, str(ROOT))
    mod = importlib.import_module("euler_tpu_torch.examples." + port_mod)
    vals = []
    for s in args.seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.main([*argv, "--device", "cpu", "--seed", str(s)])
        vals.append(float(res["eval_metric"]))
        print(f"seed {s}: eval_metric {vals[-1]:.4f}", flush=True)
    _summary(args, vals, port=True)


if __name__ == "__main__":
    main()
