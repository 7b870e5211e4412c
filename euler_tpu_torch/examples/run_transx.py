"""TransE / TransH / TransR / TransD / DistMult knowledge-graph
embeddings on the fb15k family (counterpart of
examples/TransX/run_transx.py:15-68, with the same defaults).

    python -m euler_tpu_torch.examples.run_transx [--model TransE] \\
        [--dataset fb15k237] [--seed 0] [--device cpu]

Each batch is batch_size positive triples from the engine's sample_edge
and num_negs random corrupted tails per triple (numpy's default_rng,
seeded with --seed: the reference's default_rng(0) at seed 0). The model
trains through BaseEstimator for max_steps, then evaluate takes
eval_steps batches of the same stream; prints and returns the
train_*/eval_* dict (eval_metric is the MRR of the true tail among its
corruptions). --seed seeds the engine's draws, the negatives and the
model's init.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import load_graph, train_then_evaluate
from euler_tpu_torch.models import kg_models
from euler_tpu_torch.platform import resolve_device

MODELS = ("TransE", "TransH", "TransR", "TransD", "DistMult")


def triple_input_fn(graph, num_entities: int, batch_size: int,
                    num_negs: int, rng: np.random.Generator):
    """The runners' input: sample_edge triples and uniform corrupted
    tails, the reference's arrays and dtypes."""

    def input_fn() -> Iterator[Dict[str, Any]]:
        while True:
            h, t, r = graph.sample_edge(batch_size, -1)
            neg_t = rng.integers(0, num_entities, (batch_size, num_negs))
            yield {"h": h.astype(np.int64), "r": r.astype(np.int32),
                   "t": t.astype(np.int64),
                   "neg_t": neg_t.astype(np.int64), "infer_ids": h}

    return input_fn


def build_parser(model: str = "TransE") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="fb15k237")
    ap.add_argument("--model", default=model, choices=MODELS)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--margin", type=float, default=1.0)
    ap.add_argument("--num_negs", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=500)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def kg_estimator(args, kg, dev):
    """(BaseEstimator, input_fn): args.model over the KGData kg on dev,
    and the triple stream (numpy's default_rng(args.seed))."""
    net = getattr(kg_models, args.model)(
        num_entities=kg.num_entities, num_relations=kg.num_relations,
        dim=args.dim, margin=args.margin,
        generator=torch.Generator().manual_seed(args.seed))
    est = BaseEstimator(net, dict(learning_rate=args.learning_rate,
                                  seed=args.seed),
                        model_dir=args.model_dir or None, device=dev)
    return est, triple_input_fn(kg.engine, kg.num_entities,
                                args.batch_size, args.num_negs,
                                np.random.default_rng(args.seed))


def main(argv: Optional[Sequence[str]] = None,
         model: str = "TransE") -> Dict[str, Any]:
    args = build_parser(model).parse_args(argv)
    dev = resolve_device(args.device)
    kg = load_graph(args.dataset, args.seed)
    print(f"dataset {args.dataset}: {kg.num_entities} entities, "
          f"{kg.num_relations} relations [{kg.source}]", flush=True)
    est, input_fn = kg_estimator(args, kg, dev)
    res = train_then_evaluate(est, input_fn, args.max_steps,
                              args.eval_steps)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
