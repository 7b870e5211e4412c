"""Sample-file training: labels come from a line-oriented sample file of
"label,node_id" records, the graph engine serves topology and features
(counterpart of examples/sample_solution/run_sample_solution.py:20-106,
with the same defaults).

    python -m euler_tpu_torch.examples.run_sample_solution \\
        [--sample_file PATH] [--dataset cora] [--seed 0] [--device cpu]

Without --sample_file the file is model_dir/sample.txt (model_dir
defaults to the working directory); when it does not exist it is first
written from the train split (write_samples). SupervisedGraphSage trains
through SampleEstimator on parse_fn's batches (FanoutDataFlow over the
roots, one-hot labels), train(max_steps) then evaluate(eval_steps) on
the same file; prints and returns the train_*/eval_* dict. --seed seeds
the engine's draws and the model's init.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.estimator.estimators import SampleEstimator
from euler_tpu_torch.examples.common import load_graph
from euler_tpu_torch.models.graphsage import SupervisedGraphSage
from euler_tpu_torch.platform import resolve_device


def write_samples(path, graph, node_type: int, limit: int = 0) -> int:
    """The nodes of node_type as 'label,node_id' lines (the argmax of the
    one-hot label feature); returns how many."""
    ids = graph.all_node_ids()
    ids = ids[graph.get_node_type(ids) == node_type]
    if limit:
        ids = ids[:limit]
    labels = graph.get_dense_feature(ids, "label").argmax(-1)
    with open(path, "w") as f:
        for lab, nid in zip(labels, ids):
            f.write(f"{int(lab)},{int(nid)}\n")
    return len(ids)


def make_parse_fn(flow, num_classes: int):
    """lines → the batch of their roots: the flow's fanout and features,
    one-hot float32 labels, infer_ids."""

    def parse_fn(lines: List[str]) -> Dict[str, Any]:
        labs, nodes = [], []
        for ln in lines:
            a, b = ln.split(",")
            labs.append(int(a))
            nodes.append(int(b))
        roots = np.asarray(nodes, np.uint64)
        batch = flow(roots)
        batch["labels"] = np.eye(num_classes, dtype=np.float32)[labs]
        batch["infer_ids"] = roots
        return batch

    return parse_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--sample_file", default="")
    ap.add_argument("--fanouts", default="5,5")
    ap.add_argument("--hidden_dim", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.003)
    ap.add_argument("--max_steps", type=int, default=300)
    ap.add_argument("--eval_steps", type=int, default=10)
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
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    sample_file = args.sample_file
    if not sample_file:
        out_dir = Path(args.model_dir or ".")
        out_dir.mkdir(parents=True, exist_ok=True)
        sample_file = str(out_dir / "sample.txt")
    if not Path(sample_file).exists():
        n = write_samples(sample_file, g, node_type=0)
        print(f"wrote {n} train samples to {sample_file}", flush=True)
    flow = FanoutDataFlow(g, list(fanouts), feature_ids=["feature"])
    model = SupervisedGraphSage(
        data.num_classes, data.feature_dim, multilabel=False,
        dim=args.hidden_dim, fanouts=fanouts,
        generator=torch.Generator().manual_seed(args.seed))
    est = SampleEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate, seed=args.seed),
        sample_file, make_parse_fn(flow, data.num_classes),
        model_dir=args.model_dir or None, device=dev)
    res = est.train(est.train_input_fn, args.max_steps)
    res.pop("losses")
    ev = est.evaluate(est.eval_input_fn, args.eval_steps)
    out = {**{f"train_{k}": v for k, v in res.items()},
           **{f"eval_{k}": v for k, v in ev.items()}}
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
