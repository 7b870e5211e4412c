"""The runners' shared protocols: the citation protocol and the
conv-stack citation runner (counterpart of examples/common.py:13-113:
citation_argparser, run_citation, fit_citation), the unsupervised
runners' input and train-then-evaluate (examples/{graphsage,deepwalk,
line}/run_*.py, their `--device_sampler` branches), and the engine
graph every runner reads."""

from __future__ import annotations

import argparse
import contextlib
import itertools
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from euler_tpu_torch.dataflow import FullBatchDataFlow
from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.graph import seed as seed_engine
from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet

# inside shared_graphs(): dataset name → GraphData, and id(GraphData) →
# its FullBatchDataFlow
_SHARED: Optional[Dict[Any, Any]] = None


@contextlib.contextmanager
def shared_graphs():
    """Within this block load_graph builds each dataset's engine graph
    once, and run_citation each graph's FullBatchDataFlow (and so its
    static batch) once: several runs in one process (seeds, runners)
    share them. The graphs are only read, so sharing changes no
    result."""
    global _SHARED
    outer, _SHARED = _SHARED, ({} if _SHARED is None else _SHARED)
    try:
        yield
    finally:
        _SHARED = outer


def load_graph(name: str, seed: int):
    """get_dataset(name) (shared within shared_graphs()) with the
    engine's sampler seeded (on this thread) to `seed`, as the runners'
    --seed moves the engine's draws; prints the dataset line."""
    if _SHARED is None:
        data = get_dataset(name)
    else:
        data = _SHARED.get(name)
        if data is None:
            data = _SHARED[name] = get_dataset(name)
    seed_engine(seed)
    g = data.engine
    print(f"dataset {name}: {g.node_count} nodes, {g.edge_count} directed "
          f"edges [{data.source}]", flush=True)
    return data


def fit_citation(est, max_steps: int) -> Dict[str, Any]:
    """Early-stop on the val split (node type 1), then report the test
    split (type 2) at the best-val weights. Model selection and the test
    metric both come from deterministic full-split sweeps (each node
    once, padded tail masked)."""
    res = est.train_and_evaluate(
        est.train_input_fn, est.eval_sweep_input_fn, max_steps,
        est.eval_sweep_steps(), eval_every=max(max_steps // 10, 10),
        keep_best=True)
    test = est.evaluate(lambda: est.eval_sweep_input_fn(node_type=2),
                        est.eval_sweep_steps(node_type=2))
    res["test_metric"] = test["metric"]
    res["test_loss"] = test["loss"]
    return res


def root_input_fn(graph, batch_size: int, missing: int):
    """The unsupervised runners' input (counterpart of their
    `--device_sampler` input_fn): each batch holds `batch_size` roots
    drawn by the engine's sample_node over all nodes, as engine rows
    (an id the engine lacks → `missing`, the pad row), and a sample_seed
    counting up from 1. The counter goes on across calls, as the
    reference's does, so evaluate's batches follow train's."""
    counter = itertools.count(1)

    def input_fn() -> Iterator[Dict[str, Any]]:
        while True:
            roots = graph.node_rows(graph.sample_node(batch_size, -1),
                                    missing=missing)
            yield {"rows": [roots], "infer_ids": roots,
                   "sample_seed": np.uint32(next(counter))}

    return input_fn


def train_then_evaluate(est, input_fn, max_steps: int,
                        eval_steps: int) -> Dict[str, Any]:
    """train(max_steps), then evaluate(eval_steps) on the same input, as
    a dict of train_* and eval_* entries (the per-step losses left
    out)."""
    res = est.train(input_fn, max_steps)
    res.pop("losses")
    ev = est.evaluate(input_fn, eval_steps)
    return {**{f"train_{k}": v for k, v in res.items()},
            **{f"eval_{k}": v for k, v in ev.items()}}


def citation_argparser(**defaults) -> argparse.ArgumentParser:
    """The conv-stack runners' flags, with their defaults (the
    reference's citation_argparser), plus --seed and --device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=defaults.get("dataset", "cora"))
    ap.add_argument("--hidden_dim", type=int,
                    default=defaults.get("hidden_dim", 32))
    ap.add_argument("--num_layers", type=int,
                    default=defaults.get("num_layers", 2))
    ap.add_argument("--batch_size", type=int,
                    default=defaults.get("batch_size", 128))
    ap.add_argument("--learning_rate", type=float,
                    default=defaults.get("learning_rate", 0.01))
    ap.add_argument("--max_steps", type=int,
                    default=defaults.get("max_steps", 200))
    ap.add_argument("--eval_steps", type=int,
                    default=defaults.get("eval_steps", 20))
    ap.add_argument("--dropout", type=float,
                    default=defaults.get("dropout", 0.0))
    ap.add_argument("--weight_decay", type=float,
                    default=defaults.get("weight_decay", 0.0))
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--run_mode", default="train_and_evaluate",
                    choices=["train", "evaluate", "infer",
                             "train_and_evaluate"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


class ConvModel(SuperviseModel):
    """A conv stack (BaseGNNNet "gnn") and the dense head: the
    reference's run_citation ConvModel and run_gcn GCNModel."""

    def __init__(self, num_classes: int, in_dim: int, conv_name: str,
                 dim: int = 32, num_layers: int = 2,
                 conv_kwargs: Optional[Dict] = None, dropout: float = 0.0,
                 multilabel: bool = False,
                 generator: Optional[torch.Generator] = None):
        gnn = BaseGNNNet(conv_name, in_dim, dim, num_layers,
                         conv_kwargs=conv_kwargs, dropout=dropout,
                         generator=generator)
        super().__init__(num_classes, multilabel, gnn.out_dim,
                         generator=generator)
        self.gnn = gnn

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.gnn(batch)


def full_batch_flow(data) -> FullBatchDataFlow:
    """The graph's FullBatchDataFlow over its "feature" (shared within
    shared_graphs())."""
    if _SHARED is None:
        return FullBatchDataFlow(data.engine, feature_ids=["feature"])
    flow = _SHARED.get(id(data))
    if flow is None:
        flow = _SHARED[id(data)] = FullBatchDataFlow(
            data.engine, feature_ids=["feature"])
    return flow


def run_citation(conv_name: str, args, conv_kwargs: Optional[Dict] = None,
                 model_fn: Optional[Callable] = None,
                 dataset_max_id: bool = False) -> Dict[str, Any]:
    """Train and evaluate a conv-stack model on a citation stand-in over
    FullBatchDataFlow (the reference's run_citation): ConvModel(conv_name)
    with args' widths and input dropout, or model_fn(data, generator) →
    a SuperviseModel; Adam with args' learning rate and weight decay
    (and the dataset's max_id with dataset_max_id, as run_gcn sets it);
    args.run_mode 'train_and_evaluate' (fit_citation, whose result is
    printed and returned), 'train', 'evaluate' or 'infer'."""
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.platform import resolve_device

    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    if model_fn is None:
        model = ConvModel(data.num_classes, data.feature_dim, conv_name,
                          dim=args.hidden_dim, num_layers=args.num_layers,
                          conv_kwargs=conv_kwargs, dropout=args.dropout,
                          multilabel=data.multilabel, generator=gen)
    else:
        model = model_fn(data, gen)
    est = NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay,
                    seed=args.seed,
                    max_id=data.max_id if dataset_max_id else 0),
        data.engine, full_batch_flow(data), label_fid="label",
        label_dim=data.num_classes, model_dir=args.model_dir or None,
        device=dev)
    if args.run_mode == "train":
        res = est.train(est.train_input_fn, args.max_steps)
    elif args.run_mode == "evaluate":
        res = est.evaluate(est.eval_input_fn, args.eval_steps)
    elif args.run_mode == "infer":
        res = est.infer(est.infer_input_fn)
    else:
        res = fit_citation(est, args.max_steps)
        res.pop("train_losses", None)
    print(res, flush=True)
    return res
