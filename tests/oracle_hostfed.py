"""The JAX package's own host-fed runs over seeds, the oracle of the
port's quality gates for the host-fed paths (chip_smoke.py's host-fed
quality phase, PERF.md):

    JAX_PLATFORMS=cpu python tests/oracle_hostfed.py graphsage \\
        [--seeds 0 1 ... 9]
    JAX_PLATFORMS=cpu python tests/oracle_hostfed.py deepwalk|line|unsup ...
    JAX_PLATFORMS=cpu python tests/oracle_hostfed.py \
        geniepath|scalable_sage|solution ...

runs the reference runner without --device_sampler (its defaults):
`examples/graphsage/run_graphsage.py --dataset cora` (the test micro-F1
at the best-val weights), `examples/deepwalk/run_deepwalk.py` and
`examples/line/run_line.py` on cora (the eval MRR),
`examples/graphsage/run_graphsage.py --dataset ppi --mode unsupervised`
(the eval MRR), `examples/geniepath/run_geniepath.py` and
`examples/scalable_sage/run_scalable_sage.py` on cora (the test
micro-F1 at the best-val weights), or `examples/solution/
run_solution.py` (supervise on cora: the test batches' micro-F1 at the
best-val weights), once per --seeds value. Each run seeds the engine's
sampler with the seed and sets the estimator's params["seed"] to it
(its init and dropout keys; the runners leave it at 0), as the port's
--seed moves the engine's draws, the init and the dropout. It prints
each run's metric, their mean, standard deviation and standard error.
--port runs the port's runner instead (euler_tpu_torch.examples, the
same flags plus --device cpu --seed <seed>), whose spread over seeds
enters the gates' standard error. Not a test: pytest does not collect
it.

Results on the CPU, seeds 0-9, are TEN_SEED (and, for the slice-11
runners, PORT_SD) below; chip_smoke.py's host-fed quality gates read
them.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# runner → (script, argv, the key of the metric in the reference's
# result, the key in the port's); the port's runners return the
# train_*/eval_* dict where the reference's DeepWalk and LINE return the
# eval dict, and their fit_citation dict where the reference's solution
# returns the test evaluation
RUNNERS = {
    "graphsage": ("graphsage/run_graphsage.py", ["--dataset", "cora"],
                  "test_metric", "test_metric"),
    "deepwalk": ("deepwalk/run_deepwalk.py", ["--dataset", "cora"],
                 "metric", "eval_metric"),
    "line": ("line/run_line.py", ["--dataset", "cora"], "metric",
             "eval_metric"),
    "unsup": ("graphsage/run_graphsage.py",
              ["--dataset", "ppi", "--mode", "unsupervised"],
              "eval_metric", "eval_metric"),
    "geniepath": ("geniepath/run_geniepath.py", [], "test_metric",
                  "test_metric"),
    "scalable_sage": ("scalable_sage/run_scalable_sage.py", [],
                      "test_metric", "test_metric"),
    "solution": ("solution/run_solution.py", [], "metric", "test_metric"),
}

# the reference's 10-seed results (seeds 0-9, this script on the CPU):
# runner → (mean, standard deviation over the seeds)
TEN_SEED = {
    "graphsage": (0.8176015474464261, 0.005493593484570411),
    "deepwalk": (0.9959442880749704, 0.00040843575486947413),
    "line": (0.9899687498807908, 0.0011241598651568025),
    "unsup": (0.5592304632067681, 0.01290693462615766),
    "geniepath": (0.7515473889197787, 0.03336424682246929),
    "scalable_sage": (0.7128626691764743, 0.018856458650031688),
    "solution": (0.799765625, 0.021650791710328483),
}
# the port's runners over the same seeds (--port, on the CPU), for the
# runners whose gates read it here: runner → standard deviation
PORT_SD = {
    "geniepath": 0.023329403762367213,
    "scalable_sage": 0.014435043720522173,
    "solution": 0.017238717878578516,
}


def _runner(rel: str):
    path = ROOT / "examples" / rel
    spec = importlib.util.spec_from_file_location("ref_runner", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("runner", choices=sorted(RUNNERS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--port", action="store_true")
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
    out = {"runner": args.runner, "seeds": args.seeds, key: vals,
           "mean": statistics.fmean(vals)}
    if len(vals) > 1:
        out["sd"] = statistics.stdev(vals)
        out["se"] = out["sd"] / len(vals) ** 0.5
    print(json.dumps(out))


def _port(args, rel: str, argv, key: str) -> None:
    import importlib
    import sys

    sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(
        "euler_tpu_torch.examples." + rel.split("/")[1][:-3])
    vals = []
    for s in args.seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.main([*argv, "--device", "cpu", "--seed", str(s)])
        vals.append(float(res[key]))
        print(f"seed {s}: {key} {vals[-1]:.4f}", flush=True)
    out = {"runner": args.runner, "port": True, "seeds": args.seeds,
           key: vals, "mean": statistics.fmean(vals)}
    if len(vals) > 1:
        out["sd"] = statistics.stdev(vals)
        out["se"] = out["sd"] / len(vals) ** 0.5
    print(json.dumps(out))


if __name__ == "__main__":
    main()
