"""GAE / VGAE link reconstruction (counterpart of examples/gae/run_gae.py,
with the same defaults).

    python -m euler_tpu_torch.examples.run_gae [--dataset cora] \\
        [--variational] [--seed 0] [--device cpu]

BaseGraphGAE (a two-layer GCN encoder of width 32, the inner-product
decoder) in a GaeEstimator over FullBatchDataFlow: each step's batch is
the whole node table, 128 positive edges of it and 128 random pairs, its
64 roots drawn by the engine; Adam lr 0.01 for 200 steps, then evaluate
on 20 more such batches. Prints the train_* and eval_* dict; eval_metric
is the AUC of the scores (RESULTS.md labels the gae row "mrr", but the
number is this AUC). --seed seeds the engine's root draws, the pair
draws and the init; the reference's runner takes no seed and uses 0.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.estimator.estimators import GaeEstimator
from euler_tpu_torch.examples.common import full_batch_flow, load_graph
from euler_tpu_torch.mp_utils.base_gae import BaseGraphGAE
from euler_tpu_torch.platform import resolve_device


class FlowAdapter:
    """The runner's dataflow: FullBatchDataFlow's batch with
    n_real_nodes, the node table's size (the reference runner's
    _FlowAdapter)."""

    def __init__(self, flow):
        self.flow = flow

    def __call__(self, roots):
        b = self.flow(roots)
        b["n_real_nodes"] = b["nodes"].shape[0]
        return b


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--variational", action="store_true")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_pos", type=int, default=128)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=200)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def gae_estimator(args, data, device) -> GaeEstimator:
    """The runner's model and estimator for args over data's engine."""
    model = BaseGraphGAE(data.feature_dim, dim=args.dim,
                         variational=args.variational,
                         generator=torch.Generator().manual_seed(args.seed))
    return GaeEstimator(
        model, dict(batch_size=args.batch_size, num_pos=args.num_pos,
                    learning_rate=args.learning_rate, seed=args.seed),
        data.engine, FlowAdapter(full_batch_flow(data)),
        model_dir=args.model_dir or None, device=device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    est = gae_estimator(args, data, dev)
    res = est.train(est.train_input_fn, args.max_steps)
    res.pop("losses")
    ev = est.evaluate(est.eval_input_fn, args.eval_steps)
    out = {**{f"train_{k}": v for k, v in res.items()},
           **{f"eval_{k}": v for k, v in ev.items()}}
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
