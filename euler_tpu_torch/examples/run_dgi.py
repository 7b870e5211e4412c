"""Deep Graph Infomax (counterpart of examples/dgi/run_dgi.py, with the
same defaults).

    python -m euler_tpu_torch.examples.run_dgi [--dataset cora] \\
        [--seed 0] [--device cpu]

DGI (one GCN layer of width 512) trains on the whole graph every step,
as the paper does: the graph's arrays (FullBatchDataFlow over every
node) stay on the device as the estimator's static batch, and each
step's batch is only the corruption, the feature rows in a fresh
permutation (numpy default_rng(0), as the reference's). Adam lr 0.001
for 1000 steps, evaluate on 20 more corruptions, then the standard DGI
evaluation: a ridge probe (lambda 0.1) from the frozen embeddings of the
train split (node type 0) to the one-hot labels, its accuracy on the
test split (type 2) reported as eval_metric and probe_acc. --seed
seeds the init; the reference's runner takes no seed and uses 0.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.estimator.base_estimator import (
    BaseEstimator, _to_device,
)
from euler_tpu_torch.examples.common import full_batch_flow, load_graph
from euler_tpu_torch.models.dgi import DGI
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--num_layers", type=int, default=1)
    ap.add_argument("--learning_rate", type=float, default=0.001)
    ap.add_argument("--max_steps", type=int, default=1000)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def dgi_estimator(args, data, device):
    """(estimator, the whole graph's host batch, its input_fn): the
    graph's arrays already in the estimator's static batch; input_fn
    gives one corruption a batch from the runner's permutation
    stream."""
    full = full_batch_flow(data)(data.engine.all_node_ids())
    model = DGI(data.feature_dim, dim=args.dim, num_layers=args.num_layers,
                generator=torch.Generator().manual_seed(args.seed))
    est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                    seed=args.seed),
                        model_dir=args.model_dir or None, device=device)
    est.static_batch.update(_to_device(full, est.device))
    rng = np.random.default_rng(0)

    def input_fn():
        while True:
            perm = rng.permutation(full["x"].shape[0])
            yield {"x_corrupt": full["x"][perm]}

    return est, full, input_fn


def probe_accuracy(est, full, graph) -> float:
    """The ridge probe (lambda 0.1) on the frozen embeddings: fit on the
    train split, accuracy on the test split (the reference runner's
    numpy code, in float32)."""
    ids = graph.all_node_ids()
    out = est.run_eval({"x_corrupt": full["x"]})
    emb = out.embedding.float().cpu().numpy()
    labels = graph.get_dense_feature(ids, "label").argmax(1)
    types = graph.get_node_type(ids)
    tr, te = types == 0, types == 2
    a = emb[tr].T @ emb[tr] + 0.1 * np.eye(emb.shape[1], dtype=np.float32)
    onehot = np.eye(int(labels.max()) + 1, dtype=np.float32)[labels]
    w = np.linalg.solve(a, emb[tr].T @ onehot[tr])
    return float(((emb[te] @ w).argmax(1) == labels[te]).mean())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    est, full, input_fn = dgi_estimator(args, data, dev)
    res = est.train(input_fn, args.max_steps)
    res.pop("losses")
    ev = est.evaluate(input_fn, args.eval_steps)
    # DGI's own metric (real against corrupted) saturates by design; the
    # probe on the frozen embeddings is the number that means something
    probe = probe_accuracy(est, full, data.engine)
    ev["metric"] = probe
    out = {**{f"train_{k}": v for k, v in res.items()},
           **{f"eval_{k}": v for k, v in ev.items()}, "probe_acc": probe}
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
