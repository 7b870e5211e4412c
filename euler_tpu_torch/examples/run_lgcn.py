"""LGCN node classification, a learnable graph convolution over top-k
ordered neighbor features (counterpart of examples/lgcn/run_lgcn.py,
with the same defaults).

    python -m euler_tpu_torch.examples.run_lgcn [--dataset cora] \\
        [--seed 0] [--device cpu]

FanoutDataFlow(graph, [fanout]) on the host (30 neighbors, 60 on
pubmed), LGCEncoder (k 8, dim 32) and the dense head with dropout 0.5
(0.3 on pubmed) in a NodeEstimator (Adam lr 0.01, weight decay 0.005,
batch 64, 400 steps, 800 on pubmed); prints the result dict of
fit_citation (test_metric is the test split's micro-F1 at the best-val
weights). --seed seeds the engine's root and fanout draws, the init and
the dropout.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import fit_citation, load_graph
from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.platform import resolve_device
from euler_tpu_torch.utils.encoders import LGCEncoder


class LGCNModel(SuperviseModel):
    """The runner's model: LGCEncoder "enc" over the roots' features
    (layers[0]) and their `fanout` sampled neighbors' (layers[1]), then
    SuperviseModel's dropout and head."""

    def __init__(self, num_classes: int, in_dim: int, dim: int, k: int,
                 fanout: int, multilabel: bool = False,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        enc = LGCEncoder(in_dim, dim, k, generator=generator)
        super().__init__(num_classes, multilabel, dim, dropout=dropout,
                         generator=generator)
        self.enc = enc
        self.fanout = int(fanout)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        x = batch["layers"][0]
        nbr = batch["layers"][1].reshape(x.shape[0], self.fanout, -1)
        return self.enc(x, nbr)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden_dim", type=int, default=32)
    ap.add_argument("--fanout", type=int, default=0,
                    help="0 = 60 on pubmed, 30 otherwise")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=0,
                    help="0 = 800 on pubmed, 400 otherwise")
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--dropout", type=float, default=-1.0,
                    help="-1 = 0.3 on pubmed, 0.5 otherwise")
    ap.add_argument("--weight_decay", type=float, default=0.005)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags, with the dataset's defaults filled in."""
    args = build_parser().parse_args(argv)
    is_pubmed = args.dataset == "pubmed"
    args.fanout = args.fanout or (60 if is_pubmed else 30)
    args.max_steps = args.max_steps or (800 if is_pubmed else 400)
    if args.dropout < 0:
        args.dropout = 0.3 if is_pubmed else 0.5
    return args


def lgcn_estimator(args, data, device) -> NodeEstimator:
    """The runner's model and NodeEstimator for args over data's
    engine."""
    model = LGCNModel(data.num_classes, data.feature_dim, args.hidden_dim,
                      args.k, args.fanout, multilabel=data.multilabel,
                      dropout=args.dropout,
                      generator=torch.Generator().manual_seed(args.seed))
    flow = FanoutDataFlow(data.engine, [args.fanout],
                          feature_ids=["feature"])
    return NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        data.engine, flow, label_fid="label", label_dim=data.num_classes,
        model_dir=args.model_dir or None, device=device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    est = lgcn_estimator(args, data, dev)
    res = fit_citation(est, args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
