"""The JAX package's own layerwise and full-batch citation runs over
seeds, the oracle of the port's quality gates for the layerwise family
and the message-passing runners (chip_smoke.py's quality phase,
PERF.md):

    JAX_PLATFORMS=cpu python tests/oracle_mp.py gcn [--seeds 0 1 ... 9]
    JAX_PLATFORMS=cpu python tests/oracle_mp.py fastgcn-dev ...

runs the reference runner with its defaults on cora (the test micro-F1
at the best-val weights), once per --seeds value: fastgcn
(`examples/fastgcn/run_fastgcn.py`, the host LayerwiseDataFlow),
fastgcn-dev (the same with --device_sampler), gcn, gat, appnp, agnn,
arma, sgcn, tagcn, adaptivegcn (`examples/<name>/run_<name>.py`) and dna.
Each run seeds the engine's sampler with the seed and sets the
estimator's params["seed"] to it (its init and dropout keys; the
runners leave it at 0), as the port's --seed moves the engine's draws,
the init and the dropout. It prints each run's metric, their mean,
standard deviation and standard error. --port runs the port's runner
instead (euler_tpu_torch.examples.run_<name>, the same flags plus
--device cpu --seed <seed>), whose spread over seeds enters the gates'
standard error. Not a test: pytest does not collect it.

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
# runner → (reference script, argv); the port's runner is
# euler_tpu_torch.examples.<script's file name>
RUNNERS = {
    "fastgcn": ("fastgcn/run_fastgcn.py", []),
    "fastgcn-dev": ("fastgcn/run_fastgcn.py", ["--device_sampler"]),
    "gcn": ("gcn/run_gcn.py", []),
    "gat": ("gat/run_gat.py", []),
    "appnp": ("appnp/run_appnp.py", []),
    "agnn": ("agnn/run_agnn.py", []),
    "arma": ("arma/run_arma.py", []),
    "sgcn": ("sgcn/run_sgcn.py", []),
    "tagcn": ("tagcn/run_tagcn.py", []),
    "adaptivegcn": ("adaptivegcn/run_adaptivegcn.py", []),
    "dna": ("dna/run_dna.py", []),
}

# the reference's 10-seed results (seeds 0-9, this script on the CPU):
# runner → (mean, standard deviation over the seeds)
TEN_SEED = {
    "fastgcn": (0.8345261122087445, 0.01317751248894518),
    "fastgcn-dev": (0.8400870406304843, 0.013720829649504995),
    "gcn": (0.8463249516902163, 0.010654892080689326),
    "gat": (0.8313829788041069, 0.013270344594744203),
    "appnp": (0.86407156674267, 0.00879152875152774),
    "agnn": (0.8811411992032477, 0.007645059412999617),
    "arma": (0.856769826114754, 0.010915064239256573),
    "sgcn": (0.8836557060191895, 0.005528479769290648),
    "tagcn": (0.8560928434421753, 0.014651474060142045),
    "adaptivegcn": (0.8135396519528136, 0.0052438846221928214),
    "dna": (0.8204545455121902, 0.0212216359516183),
}
# the port's runners over the same seeds (--port, on the CPU): runner →
# standard deviation over the seeds
PORT_SD = {
    "fastgcn": 0.011954006951623365,
    "fastgcn-dev": 0.01315185643284568,
    "gcn": 0.020169814444939625,
    "gat": 0.010551119834804182,
    "appnp": 0.015770004740983928,
    "agnn": 0.009738242667255934,
    "arma": 0.007040725253407239,
    "sgcn": 0.006260175008564555,
    "tagcn": 0.024064638931257393,
    "adaptivegcn": 0.012062511298253743,
    "dna": 0.020223842916213673,
}


def _runner(rel: str):
    import sys

    path = ROOT / "examples" / rel
    spec = importlib.util.spec_from_file_location("ref_runner", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs: a runner that defines a flax module at
    # its top level (run_gcn) needs its module in sys.modules
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _summary(args, vals, **extra) -> None:
    out = {"runner": args.runner, **extra, "seeds": args.seeds,
           "test_metric": vals, "mean": statistics.fmean(vals)}
    if len(vals) > 1:
        out["sd"] = statistics.stdev(vals)
        out["se"] = out["sd"] / len(vals) ** 0.5
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("runner", choices=sorted(RUNNERS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    rel, argv = RUNNERS[args.runner]
    if args.port:
        return _port(args, rel, argv)
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
        vals.append(float(res["test_metric"]))
        print(f"seed {s}: test_metric {vals[-1]:.4f}", flush=True)
    B.BaseEstimator.__init__ = base_init
    _summary(args, vals)


def _port(args, rel: str, argv) -> None:
    import importlib
    import sys

    sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(
        "euler_tpu_torch.examples." + rel.split("/")[1][:-3])
    vals = []
    for s in args.seeds:
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.main([*argv, "--device", "cpu", "--seed", str(s)])
        vals.append(float(res["test_metric"]))
        print(f"seed {s}: test_metric {vals[-1]:.4f}", flush=True)
    _summary(args, vals, port=True)


if __name__ == "__main__":
    main()
