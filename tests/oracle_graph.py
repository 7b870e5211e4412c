"""The JAX package's own graph-classification and zoo runs over seeds,
the oracle of the port's quality gates for slice 10 (chip_smoke.py's
quality phase, PERF.md):

    JAX_PLATFORMS=cpu python tests/oracle_graph.py gin [--seeds 0 1 ... 9]

runs the reference runner with its defaults, once per --seeds value:
the mutag runners gin, graphgcn, gated_graph and set2set
(`examples/<name>/run_<name>.py`; their eval accuracy at the best
sweep's weights), lgcn on cora (the test micro-F1 at the best-val
weights), gae on cora (the eval AUC, which RESULTS.md labels "mrr") and
dgi on cora (the ridge probe's accuracy). The reference's runners take
no seed: each run here seeds the engine's sampler with the seed and
sets params["seed"] to it in BaseEstimator (the init and dropout keys)
and in GraphEstimator and GaeEstimator (their numpy batch streams), as
the port's --seed moves the engine's draws, the init, the dropout and
those streams. Nothing in euler_tpu/ or examples/ is edited: the
constructors are wrapped while the script runs. It prints each run's
metric, their mean, standard deviation and standard error. --port runs
the port's runner instead (euler_tpu_torch.examples.run_<name>, the
same flags plus --device cpu --seed <seed>), whose spread over seeds
enters the gates' standard error. Not a test: pytest does not collect
it.

Results on the CPU, seeds 0-9, are TEN_SEED and PORT_SD below;
chip_smoke.py's quality gates read them.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# runner → (reference script, argv, the reference's result key, the
# port's); the port's runner is euler_tpu_torch.examples.<script's file
# name>. The reference's gae and dgi return evaluate()'s dict.
RUNNERS = {
    "gin": ("gin/run_gin.py", [], "eval_metric", "eval_metric"),
    "graphgcn": ("graphgcn/run_graphgcn.py", [], "eval_metric",
                 "eval_metric"),
    "gated_graph": ("gated_graph/run_gated_graph.py", [], "eval_metric",
                    "eval_metric"),
    "set2set": ("set2set/run_set2set.py", [], "eval_metric", "eval_metric"),
    "lgcn": ("lgcn/run_lgcn.py", [], "test_metric", "test_metric"),
    "gae": ("gae/run_gae.py", [], "metric", "eval_metric"),
    "dgi": ("dgi/run_dgi.py", [], "metric", "eval_metric"),
}

# the reference's 10-seed results (seeds 0-9, this script on the CPU):
# runner → (mean, standard deviation over the seeds)
TEN_SEED = {
    "gin": (0.9052631578947368, 0.013589415249850629),
    "graphgcn": (0.8736842105263157, 0.01664356553020527),
    "gated_graph": (0.9289473684210525, 0.012711733987885512),
    "set2set": (0.9210526315789472, 0.0),
    "lgcn": (0.7452127659920336, 0.02496198161920006),
    "gae": (0.878377685546875, 0.012587291748332317),
    "dgi": (0.6916827852998065, 0.03612530555714695),
}
# the port's runners over the same seeds (--port, on the CPU): runner →
# standard deviation over the seeds
PORT_SD = {
    "gin": 0.013869638860387671,
    "graphgcn": 0.02075817494267474,
    "gated_graph": 0.013589415249850629,
    "set2set": 0.01240538212607982,
    "lgcn": 0.030827870884988888,
    "gae": 0.018222931113287703,
    "dgi": 0.03268054359742111,
}


def _runner(rel: str):
    import sys

    path = ROOT / "examples" / rel
    spec = importlib.util.spec_from_file_location("ref_runner", path)
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


def _seeded(cls, s: int):
    """cls.__init__ with params["seed"] = s; returns the original."""
    init = cls.__init__

    def seeded(self, model, params, *a, **kw):
        init(self, model, {**params, "seed": s}, *a, **kw)

    cls.__init__ = seeded
    return init


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
    from euler_tpu.estimator import estimators as E
    from euler_tpu.graph import seed

    classes = (B.BaseEstimator, E.GraphEstimator, E.GaeEstimator)
    vals = []
    for s in args.seeds:
        inits = [_seeded(cls, s) for cls in classes]
        seed(s)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                res = run.main(argv)
        finally:
            for cls, init in zip(classes, inits):
                cls.__init__ = init
        vals.append(float(res[key]))
        print(f"seed {s}: {key} {vals[-1]:.4f}", flush=True)
    _summary(args, vals)


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
    _summary(args, vals, port=True)


if __name__ == "__main__":
    main()
