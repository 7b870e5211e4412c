"""The JAX package's own unsupervised GraphSAGE run on the ppi stand-in,
the oracle of the port's quality gate for that path (chip_smoke.py's
quality phase). RESULTS.md has no row for this path: its
`graphsage-unsup | ppi` row is the host-fed EdgeEstimator.

    JAX_PLATFORMS=cpu python tests/oracle_unsup_ppi.py [--seeds 0 1 2]

runs `examples/graphsage/run_graphsage.py --dataset ppi --mode
unsupervised --device_sampler` (its defaults: batch 64, lr 0.003,
num_negs 5, 600 steps, 20 eval steps) once with the engine's default
RNG seed, then once per --seeds value with the engine's sampler
seeded to it (the runner has no seed flag; the seed moves its root
draws), and prints each eval MRR and the mean over the seeds. About a
minute per run on a CPU. Not a test: pytest does not collect it.
"""

import argparse
import contextlib
import importlib.util
import io
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--dataset", "ppi", "--mode", "unsupervised", "--device_sampler"]


def _runner():
    path = ROOT / "examples" / "graphsage" / "run_graphsage.py"
    spec = importlib.util.spec_from_file_location("ref_run_graphsage", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    args = ap.parse_args()
    run = _runner()
    from euler_tpu.graph import seed

    out = {}
    for s in [None, *args.seeds]:
        if s is not None:
            seed(s)
        with contextlib.redirect_stdout(io.StringIO()):
            res = run.main(ARGS)
        out["default" if s is None else f"seed {s}"] = res["eval_metric"]
        print(f"engine seed {s if s is not None else 'default'}: eval MRR "
              f"{res['eval_metric']:.4f}", flush=True)
    seeded = [out[f"seed {s}"] for s in args.seeds]
    if seeded:
        out["mean_over_seeds"] = sum(seeded) / len(seeded)
        out["spread_over_seeds"] = max(seeded) - min(seeded)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
