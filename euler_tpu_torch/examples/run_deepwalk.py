"""DeepWalk / node2vec (counterpart of examples/deepwalk/run_deepwalk.py:
19-113, with the same defaults).

    python -m euler_tpu_torch.examples.run_deepwalk [--device_sampler] \\
        [--dataset cora|ml_1m] [--p 1 --q 1] [--steps_per_loop K] [--seed 0] \\
        [--device cpu]

The graph is get_dataset(dataset).engine. Without --device_sampler the
input is host-fed: roots from the engine's sample_node, node2vec walks
from its random_walk, skip-gram pairs from gen_pair and
num_negs negatives per pair from sample_node feed DeepWalk. With
--device_sampler, DeviceSampledSkipGram draws walks, pairs and
negatives on the device from tables built from the engine, on roots the
engine draws. A plain BaseEstimator trains, train(max_steps), then
evaluate(eval_steps); prints the train_*/eval_* dict (eval_metric is
the MRR). max_steps 0 means about 10 root walks per node, max(500,
10·N / batch_size) (1,522 steps on ml_1m). --steps_per_loop K > 1 runs
each window of K steps as one CUDA graph replay on the card, on either
input path, the same steps as K = 1. --seed seeds the engine's draws
and the tables' init.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import (
    load_graph, root_input_fn, train_then_evaluate,
)
from euler_tpu_torch.models.embedding_models import (
    DeepWalk, DeviceSampledSkipGram,
)
from euler_tpu_torch.ops.walk_ops import gen_pair
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--walk_len", type=int, default=5)
    ap.add_argument("--left_win", type=int, default=1)
    ap.add_argument("--right_win", type=int, default=1)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--num_negs", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.025)
    ap.add_argument("--max_steps", type=int, default=0,
                    help="0 = auto: about 10 root walks per node")
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--device_sampler", action="store_true",
                    help="walks, pairs and negatives drawn on the device "
                         "from tables built from the engine")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--steps_per_loop", type=int, default=1,
                    help="> 1 runs K steps as one CUDA graph replay")
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def walk_tables(g, cap: int, dev):
    """The neighbor table and the node sampler over all nodes
    (DeviceNeighborTable(g, cap), DeviceNodeSampler(g, node_type=-1))."""
    return (DeviceNeighborTable(g, cap=cap, device=dev),
            DeviceNodeSampler(g, node_type=-1, device=dev))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    g = data.engine
    if not args.max_steps:
        args.max_steps = max(500, int(10 * g.node_count / args.batch_size))
    init = torch.Generator().manual_seed(args.seed)
    if args.device_sampler:
        tab, neg = walk_tables(g, args.sampler_cap, dev)
        model = DeviceSampledSkipGram(
            tab.pad_row, dim=args.dim, walk_len=args.walk_len,
            left_win=args.left_win, right_win=args.right_win,
            num_negs=args.num_negs, p=args.p, q=args.q, generator=init)
        est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                        steps_per_loop=args.steps_per_loop,
                                        seed=args.seed),
                            model_dir=args.model_dir or None, device=dev)
        est.static_batch.update({**tab.tables, **neg.tables})
        input_fn = root_input_fn(g, args.batch_size, tab.pad_row)
    else:
        model = DeepWalk(data.max_id, dim=args.dim, generator=init)
        est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                        max_id=data.max_id,
                                        steps_per_loop=args.steps_per_loop,
                                        seed=args.seed),
                            model_dir=args.model_dir or None, device=dev)

        def input_fn():
            while True:
                roots = g.sample_node(args.batch_size, -1)
                walks = g.random_walk(roots, args.walk_len, p=args.p,
                                      q=args.q)
                flat = gen_pair(walks, args.left_win,
                                args.right_win).reshape(-1, 2)
                negs = g.sample_node(
                    flat.shape[0] * args.num_negs, -1).reshape(
                        flat.shape[0], args.num_negs)
                yield {"src": flat[:, 0], "pos": flat[:, 1], "negs": negs,
                       "infer_ids": flat[:, 0]}
    res = train_then_evaluate(est, input_fn, args.max_steps,
                              args.eval_steps)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
