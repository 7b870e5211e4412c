"""LINE, first- and second-order proximity (counterpart of
examples/line/run_line.py:15-103, with the same defaults and auto
rules).

    python -m euler_tpu_torch.examples.run_line [--device_sampler] \\
        [--dataset cora|ml_1m] [--order 2] [--steps_per_loop K] \\
        [--seed 0] [--device cpu]

The graph is get_dataset(dataset).engine. Without --device_sampler the
input is host-fed: positive edges from the engine's sample_edge and
num_negs negatives per edge from its sample_node feed LINE. With
--device_sampler, LINE is a walk_len-1 skip-gram (DeviceSampledSkipGram,
window (0, 1)) on tables built from the engine: each root's one
weighted neighbor is its positive; order 1 shares the context table. A
plain BaseEstimator trains, train(max_steps), then evaluate(eval_steps);
prints the train_*/eval_* dict (eval_metric is the MRR). Auto values
(0): dim 256 on pubmed else 128, lr 0.05 on pubmed else 0.025,
max_steps 8000 on pubmed else max(500, 8·E / batch_size) with E the
engine's directed edges (125,026 steps on ml_1m). --steps_per_loop
K > 1 runs each window of K steps as one CUDA graph replay on the card
(host-fed batches are copied into the graph's inputs), the same steps
as K = 1; on the CPU the K steps run eagerly. --seed seeds the engine's
draws and the tables' init.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import (
    load_graph, root_input_fn, train_then_evaluate,
)
from euler_tpu_torch.examples.run_deepwalk import walk_tables
from euler_tpu_torch.models.embedding_models import (
    LINE, DeviceSampledSkipGram,
)
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--dim", type=int, default=0,
                    help="0 = auto (256 on pubmed, 128 otherwise)")
    ap.add_argument("--order", type=int, default=2, choices=[1, 2])
    ap.add_argument("--num_negs", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--learning_rate", type=float, default=0.0,
                    help="0 = auto (0.05 on pubmed, 0.025 otherwise)")
    ap.add_argument("--max_steps", type=int, default=0,
                    help="0 = auto: 8000 on pubmed, ~8 epochs otherwise")
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--device_sampler", action="store_true",
                    help="positives and negatives drawn on the device "
                         "from tables built from the engine")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--steps_per_loop", type=int, default=1,
                    help="> 1 runs K steps as one CUDA graph replay")
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    g = data.engine
    is_pubmed = args.dataset == "pubmed"
    args.dim = args.dim or (256 if is_pubmed else 128)
    args.learning_rate = args.learning_rate or (0.05 if is_pubmed else 0.025)
    if not args.max_steps:
        args.max_steps = 8000 if is_pubmed else max(
            500, int(8 * g.edge_count / args.batch_size))
    init = torch.Generator().manual_seed(args.seed)
    if args.device_sampler:
        tab, neg = walk_tables(g, args.sampler_cap, dev)
        model = DeviceSampledSkipGram(
            tab.pad_row, dim=args.dim, walk_len=1, left_win=0, right_win=1,
            num_negs=args.num_negs, share_context=args.order == 1,
            generator=init)
        est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                        steps_per_loop=args.steps_per_loop,
                                        seed=args.seed),
                            model_dir=args.model_dir or None, device=dev)
        est.static_batch.update({**tab.tables, **neg.tables})
        input_fn = root_input_fn(g, args.batch_size, tab.pad_row)
    else:
        model = LINE(data.max_id, dim=args.dim, order=args.order,
                     generator=init)
        est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                        max_id=data.max_id,
                                        steps_per_loop=args.steps_per_loop,
                                        seed=args.seed),
                            model_dir=args.model_dir or None, device=dev)

        def input_fn():
            while True:
                src, dst, _ = g.sample_edge(args.batch_size, -1)
                negs = g.sample_node(
                    args.batch_size * args.num_negs, -1).reshape(
                        args.batch_size, args.num_negs)
                yield {"src": src, "pos": dst, "negs": negs,
                       "infer_ids": src}
    res = train_then_evaluate(est, input_fn, args.max_steps,
                              args.eval_steps)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
