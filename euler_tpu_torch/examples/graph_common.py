"""The whole-graph classification runners' shared protocol (counterpart
of examples/graph_common.py: graph_argparser, run_graph_model), for the
mutag family: run_gin, run_graphgcn, run_gated_graph, run_set2set.

GraphModel(conv, pool) in a GraphEstimator (Adam with weight decay, 16
graphs a batch drawn with replacement from the train split), evaluated
every max_steps // 10 steps (at least 10) on the deterministic sweep of
the eval split; the weights of the best sweep are kept and reported
(keep_best, the GIN paper's best-epoch protocol that the reference's
mutag rows follow). --seed seeds the init, the batch draws and the
dropout; the reference's runners take no seed and use 0.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.estimator.estimators import GraphEstimator
from euler_tpu_torch.mp_utils.graph_gnn import GraphModel
from euler_tpu_torch.platform import resolve_device


def graph_argparser(**defaults) -> argparse.ArgumentParser:
    """The mutag runners' flags with their defaults (the reference's
    graph_argparser), plus --seed and --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mutag")
    ap.add_argument("--hidden_dim", type=int,
                    default=defaults.get("hidden_dim", 32))
    ap.add_argument("--num_layers", type=int,
                    default=defaults.get("num_layers", 2))
    ap.add_argument("--num_graphs", type=int,
                    default=defaults.get("num_graphs", 16))
    ap.add_argument("--learning_rate", type=float,
                    default=defaults.get("learning_rate", 0.01))
    ap.add_argument("--max_steps", type=int,
                    default=defaults.get("max_steps", 500))
    ap.add_argument("--eval_steps", type=int,
                    default=defaults.get("eval_steps", 20))
    ap.add_argument("--dropout", type=float,
                    default=defaults.get("dropout", 0.5))
    ap.add_argument("--weight_decay", type=float,
                    default=defaults.get("weight_decay", 0.005))
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def graph_estimator(conv_name: str, pool_name: str, args, data=None,
                    device=None) -> GraphEstimator:
    """The runners' GraphModel and GraphEstimator for args (data: a
    GraphSetData, default get_dataset(args.dataset))."""
    data = data if data is not None else get_dataset(args.dataset)
    model = GraphModel(
        data.feature_dim, conv_name=conv_name, pool_name=pool_name,
        dim=args.hidden_dim, num_layers=args.num_layers,
        num_graphs=args.num_graphs, num_classes=data.num_classes,
        dropout=args.dropout,
        generator=torch.Generator().manual_seed(args.seed))
    return GraphEstimator(
        model, dict(num_graphs=args.num_graphs,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed,
                    train_indices=data.train_indices,
                    eval_indices=data.eval_indices),
        data.graphs, data.labels, model_dir=args.model_dir or None,
        device=device)


def run_graph_model(conv_name: str, pool_name: str,
                    args) -> Dict[str, Any]:
    """Train and evaluate GraphModel(conv_name, pool_name) on args'
    dataset; prints and returns train_and_evaluate's dict (eval_metric
    is the eval split's accuracy at the best sweep's weights)."""
    dev = resolve_device(args.device)
    est = graph_estimator(conv_name, pool_name, args, device=dev)
    # eval_steps covers the whole deterministic sweep
    eval_steps = max(args.eval_steps, est.eval_steps())
    res = est.train_and_evaluate(est.train_input_fn, est.eval_input_fn,
                                 args.max_steps, eval_steps,
                                 eval_every=max(args.max_steps // 10, 10),
                                 keep_best=True)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res
