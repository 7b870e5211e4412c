"""The JAX package's own citation runs over engine seeds, the oracle of
the port's quality gates where a 3-seed mean misses its RESULTS.md row
(chip_smoke.py's quality phase, PERF.md):

    JAX_PLATFORMS=cpu python tests/oracle_citation.py geniepath \\
        [--dataset cora] [--seeds 0 1 2]
    JAX_PLATFORMS=cpu python tests/oracle_citation.py act_cache ...

runs `examples/geniepath/run_geniepath.py --device_sampler` or
`examples/graphsage/run_graphsage.py --device_sampler --act_cache` (their
defaults) once per --seeds value with the engine's sampler seeded to it
(the runners have no seed flag; the seed moves their root draws), and
prints each test micro-F1, their mean and standard deviation.
--vary_init also sets the estimator's params["seed"] to the seed (its
init key and dropout key; the runners leave it at 0), as the port's
--seed moves its init. Not a test: pytest does not collect it.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNNERS = {
    "geniepath": ("geniepath/run_geniepath.py", ["--device_sampler"]),
    "act_cache": ("graphsage/run_graphsage.py",
                  ["--device_sampler", "--act_cache"]),
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
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--vary_init", action="store_true")
    args = ap.parse_args()
    rel, argv = RUNNERS[args.runner]
    run = _runner(rel)
    import euler_tpu.estimator as E
    from euler_tpu.graph import seed

    node_estimator = E.NodeEstimator
    f1 = []
    for s in args.seeds:
        seed(s)
        if args.vary_init:
            def seeded(model, params, *a, _s=s, **kw):
                return node_estimator(model, {**params, "seed": _s}, *a,
                                      **kw)
            E.NodeEstimator = seeded
        with contextlib.redirect_stdout(io.StringIO()):
            res = run.main(["--dataset", args.dataset, *argv])
        f1.append(float(res["test_metric"]))
        print(f"engine seed {s}: test micro-F1 {f1[-1]:.4f}", flush=True)
    out = {"runner": args.runner, "dataset": args.dataset,
           "seeds": args.seeds, "vary_init": args.vary_init,
           "test_micro_f1": f1,
           "mean": statistics.fmean(f1)}
    if len(f1) > 1:
        out["sd"] = statistics.stdev(f1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
