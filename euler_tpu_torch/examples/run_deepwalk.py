"""DeepWalk / node2vec with walks, pairs and negatives drawn on the
device (counterpart of examples/deepwalk/run_deepwalk.py:19-93, its
--device_sampler branch, with the same defaults).

    python -m euler_tpu_torch.examples.run_deepwalk --device_sampler \\
        [--dataset cora] [--p 1 --q 1] [--steps_per_loop K] [--seed 0] \\
        [--device cpu]

Trains DeviceSampledSkipGram with a plain BaseEstimator on roots drawn
over all nodes: train(max_steps), then evaluate(eval_steps); prints the
train_*/eval_* dict (eval_metric is the MRR). max_steps 0 means about
10 root walks per node, max(500, 10·N / batch_size). --seed seeds the
tables' init and the root draws. The host-fed DeepWalk model (walks
from the graph engine) waits for the engine binding.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import root_input_fn, train_then_evaluate
from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.platform import resolve_device

_ROADMAP_HOST_FED = ("the host-fed DeepWalk model (walks and pairs from the "
                     "graph engine) is not ported yet: ROADMAP.md Queue A, "
                     "'Engine binding'; pass --device_sampler")


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
                    help="walks, pairs and negatives on the device (the "
                         "only path ported)")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--steps_per_loop", type=int, default=1,
                    help="> 1 runs K steps as one CUDA graph replay")
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def walk_tables(data, cap: int, dev):
    """The neighbor table and the unit-weight node sampler over all
    nodes (the reference's DeviceNeighborTable(g, cap) and
    DeviceNodeSampler(g, node_type=-1) on the stand-in's unit weights)."""
    tab = DeviceNeighborTable.from_csr(data.offsets, data.neighbors,
                                       cap=cap, device=dev)
    neg = DeviceNodeSampler.from_arrays(np.ones(data.num_nodes, np.float32),
                                        device=dev)
    return tab, neg


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if not args.device_sampler:
        raise NotImplementedError(_ROADMAP_HOST_FED)
    dev = resolve_device(args.device)
    data = get_dataset(args.dataset)
    if not args.max_steps:
        args.max_steps = max(500, int(10 * data.num_nodes / args.batch_size))
    print(f"dataset {args.dataset}: {data.num_nodes} nodes [synthetic]",
          flush=True)
    tab, neg = walk_tables(data, args.sampler_cap, dev)
    model = DeviceSampledSkipGram(
        tab.pad_row, dim=args.dim, walk_len=args.walk_len,
        left_win=args.left_win, right_win=args.right_win,
        num_negs=args.num_negs, p=args.p, q=args.q,
        generator=torch.Generator().manual_seed(args.seed))
    est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                    steps_per_loop=args.steps_per_loop,
                                    seed=args.seed),
                        model_dir=args.model_dir or None, device=dev)
    est.static_batch.update({**tab.tables, **neg.tables})
    res = train_then_evaluate(
        est, root_input_fn(data.num_nodes, args.batch_size, args.seed),
        args.max_steps, args.eval_steps)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
