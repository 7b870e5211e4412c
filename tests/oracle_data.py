"""The JAX package's own runs over seeds on the datasets of the
registry's last slice (ml_1m, digits_knn), the oracle of the port's
quality gates there (chip_smoke.py's data quality phase, PERF.md):

    JAX_PLATFORMS=cpu python tests/oracle_data.py deepwalk-ml_1m \\
        [--seeds 0 1 ... 9]
    JAX_PLATFORMS=cpu python tests/oracle_data.py line-ml_1m ...
    JAX_PLATFORMS=cpu python tests/oracle_data.py \\
        gcn|graphsage|geniepath|lgcn|arma-digits_knn ...

runs the reference runner with its defaults on the dataset
(`examples/<name>/run_<name>.py --dataset <set>`, host-fed): the eval
MRR of DeepWalk and LINE on the synthetic MovieLens-1M graph (9,746
nodes, 2,000,418 directed rated edges; DeepWalk 1,522 steps, LINE
125,026 steps at batch 128, the runners' auto rules), the test micro-F1
at the best-val weights of the five citation runners on digits_knn
(sklearn's digits with k-NN edges; tools/collect_results.py:51-52). Each
run seeds the engine's sampler with the seed and sets the estimator's
params["seed"] to it (its init and dropout keys; the runners leave it
at 0), as the port's --seed moves the engine's draws, the init and the
dropout. It prints each run's metric, their mean, standard deviation
and standard error. --port runs the port's runner instead
(euler_tpu_torch.examples.run_<name>, the same flags plus --device
<--device, default cpu> --seed <seed>; --steps_per_loop K is passed on
to it: on a CUDA device K steps replay as one CUDA graph, the same
steps as K = 1), whose spread over seeds enters the gates' standard
error. Not a test: pytest does not collect it.

Results, seeds 0-9 (PERF.md §6): TEN_SEED (the reference on the CPU)
and PORT_TEN_SEED (the port on the card) below; chip_smoke.py's data
quality gates read them. digits_knn needs sklearn, which the GPU host
does not have: those rows are checked on the CPU only (DIGITS below,
seeds 0-2 of both packages).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# runner → (reference script, argv, the key of the metric in the
# reference's result, the key in the port's): the reference's DeepWalk
# and LINE return their eval dict, the port's the train_*/eval_* dict
RUNNERS = {
    "deepwalk-ml_1m": ("deepwalk/run_deepwalk.py", ["--dataset", "ml_1m"],
                       "metric", "eval_metric"),
    "line-ml_1m": ("line/run_line.py", ["--dataset", "ml_1m"], "metric",
                   "eval_metric"),
    **{f"{m}-digits_knn": (f"{m}/run_{m}.py", ["--dataset", "digits_knn"],
                           "test_metric", "test_metric")
       for m in ("gcn", "graphsage", "geniepath", "lgcn", "arma")},
}

# the reference's 10-seed results (seeds 0-9, this script on the CPU):
# runner → (mean, standard deviation over the seeds)
TEN_SEED = {
    "deepwalk-ml_1m": (0.6365560159087181, 0.003736637609803062),
    "line-ml_1m": (0.6771627685427666, 0.008676160632389601),
}
# the port's runners over the same seeds (--port --device cuda on an
# H100, LINE with --steps_per_loop 32): runner → (mean, standard
# deviation over the seeds)
# (the port's CPU runs: DeepWalk seeds 0-9 0.6380, sd 0.0035; LINE
# seeds 0, 1: 0.6729, 0.6774)
PORT_TEN_SEED = {
    "deepwalk-ml_1m": (0.6379356986284257, 0.003579637881115603),
    "line-ml_1m": (0.6819329491257669, 0.007305086218084711),
}
# digits_knn, seeds 0-2 on the CPU: runner → (the RESULTS.md row, the
# reference's mean, the port's mean); each package's mean lies within
# 0.01 of the row
DIGITS = {
    "gcn-digits_knn": (0.967, 0.9719353973597232, 0.9692877937411075),
    "graphsage-digits_knn": (0.966, 0.9706115961264201, 0.9729944396530285),
    "geniepath-digits_knn": (0.963, 0.966375429856894, 0.9682287524735641),
    "lgcn-digits_knn": (0.972, 0.9629335449364945, 0.9658459097991269),
    "arma-digits_knn": (0.974, 0.9708763560921798, 0.9706115970890578),
}


def _runner(rel: str):
    path = ROOT / "examples" / rel
    spec = importlib.util.spec_from_file_location("ref_runner", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs: a runner that defines a flax module at
    # its top level needs its module in sys.modules
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _summary(args, key: str, vals, **extra) -> None:
    out = {"runner": args.runner, **extra, "seeds": args.seeds, key: vals,
           "mean": statistics.fmean(vals)}
    if len(vals) > 1:
        out["sd"] = statistics.stdev(vals)
        out["se"] = out["sd"] / len(vals) ** 0.5
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("runner", choices=sorted(RUNNERS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps_per_loop", type=int, default=1)
    args = ap.parse_args()
    rel, argv, key, port_key = RUNNERS[args.runner]
    if args.port:
        return _port(args, rel, argv, port_key)
    run = _runner(rel)
    from euler_tpu.estimator import base_estimator as B
    from euler_tpu.graph import seed

    base_init = B.BaseEstimator.__init__
    vals = []
    for s in args.seeds:
        def seeded(self, model, params, *a, _s=s, **kw):
            base_init(self, model, {**params, "seed": _s}, *a, **kw)
        B.BaseEstimator.__init__ = seeded
        seed(s)
        with contextlib.redirect_stdout(io.StringIO()):
            res = run.main(argv)
        vals.append(float(res[key]))
        print(f"seed {s}: {key} {vals[-1]:.4f}", flush=True)
    B.BaseEstimator.__init__ = base_init
    _summary(args, key, vals)


def _port(args, rel: str, argv, key: str) -> None:
    import importlib

    sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(
        "euler_tpu_torch.examples." + rel.split("/")[1][:-3])
    extra = (["--steps_per_loop", str(args.steps_per_loop)]
             if args.steps_per_loop > 1 else [])
    vals = []
    for s in args.seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.main([*argv, *extra, "--device", args.device,
                            "--seed", str(s)])
        vals.append(float(res[key]))
        print(f"seed {s}: {key} {vals[-1]:.4f}", flush=True)
    _summary(args, key, vals, port=True, device=args.device)


if __name__ == "__main__":
    main()
