"""Solution templates: supervised or unsupervised pipelines assembled
from the solution layer's parts (counterpart of
examples/solution/run_solution.py:14-66, with the same defaults).

    python -m euler_tpu_torch.examples.run_solution \\
        [--mode supervise|unsupervise] [--logits dot|cosine] \\
        [--dataset cora] [--seed 0] [--device cpu]

supervise: SuperviseSolution on BaseEstimator, trained on the train
split's roots and evaluated every max_steps / 10 steps on val-split
batches (node type 1), the best weights kept; then evaluated on
test-split batches (type 2). Prints and returns the train_*/eval_* dict
with test_metric (micro-F1) and test_loss. unsupervise:
UnsuperviseSolution, train(max_steps) then evaluate(eval_steps) on the
same input; prints and returns the train_*/eval_* dict (eval_metric is
the MRR). --seed seeds the engine's draws and the model's init (the
reference's estimator seed, default 0).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import load_graph
from euler_tpu_torch.platform import resolve_device
from euler_tpu_torch.solution import SuperviseSolution, UnsuperviseSolution


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--mode", default="supervise",
                    choices=["supervise", "unsupervise"])
    ap.add_argument("--fanouts", default="10,10")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--logits", default="dot", choices=["dot", "cosine"])
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.003)
    ap.add_argument("--weight_decay", type=float, default=0.001)
    ap.add_argument("--max_steps", type=int, default=400)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def build_estimator(args, data, dev):
    """(BaseEstimator, solution): the solution of args.mode over data's
    engine, its model in a BaseEstimator on dev."""
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    init = torch.Generator().manual_seed(args.seed)
    if args.mode == "supervise":
        sol = SuperviseSolution(
            data.engine, fanouts=fanouts, dim=args.dim,
            num_classes=data.num_classes, multilabel=data.multilabel,
            batch_size=args.batch_size, generator=init)
    else:
        sol = UnsuperviseSolution(
            data.engine, fanouts=fanouts, dim=args.dim, max_id=data.max_id,
            batch_size=args.batch_size, logits=args.logits,
            generator=init)
    est = BaseEstimator(sol.model,
                        dict(learning_rate=args.learning_rate,
                             weight_decay=args.weight_decay,
                             max_id=data.max_id, seed=args.seed),
                        model_dir=args.model_dir or None, device=dev)
    return est, sol


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    est, sol = build_estimator(args, data, dev)
    if args.mode == "supervise":
        # early-stop on val (type 1), report test (type 2): solutions
        # sample train nodes by default
        res = est.train_and_evaluate(
            sol.input_fn, lambda: sol.input_fn(1),
            args.max_steps, args.eval_steps,
            eval_every=max(args.max_steps // 10, 10), keep_best=True)
        test = est.evaluate(lambda: sol.input_fn(2), args.eval_steps)
        res["test_metric"] = test["metric"]
        res["test_loss"] = test["loss"]
    else:
        res = est.train(sol.input_fn, args.max_steps)
        ev = est.evaluate(sol.input_fn, args.eval_steps)
        res = {**{f"train_{k}": v for k, v in res.items()},
               **{f"eval_{k}": v for k, v in ev.items()}}
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
