"""R-GCN link prediction on the fb15k family (counterpart of
examples/rgcn/run_rgcn.py:19-108, with the same defaults): the runner's
own RGCNLinkModel, a relational encoder of the head over its per-relation
neighbor draws, scored with DistMult.

    python -m euler_tpu_torch.examples.run_rgcn [--dataset fb15k237] \\
        [--seed 0] [--device cpu]

Each batch is batch_size sample_edge triples; num_rel_sample relations
drawn without replacement (with, when the graph has fewer), and for each
a typed sample_neighbor of `fanout` for every head, stacked [R, B, K];
num_negs random corrupted tails per triple. numpy's default_rng is
seeded with --seed (the reference's default_rng(0) at seed 0), and the
engine's draws too. train(max_steps), then evaluate(eval_steps) on the
same stream; prints and returns the train_*/eval_* dict (eval_metric is
the MRR).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from euler_tpu_torch.convolution.gat_conv import glorot_uniform
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.examples.common import load_graph, train_then_evaluate
from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.platform import resolve_device
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import Embedding


class RGCNLinkModel(nn.Module):
    """The head's embedding refined by the relation-wise mean of its
    sampled neighbors' embeddings (RelationConv's message on fanout
    batches), scored by DistMult: h = relu(ent(h) + Σ_r mean_k
    ent(nbr_r) · w_rel[r] / R), pos = <h, r, t>, the margin-1 ranking
    loss against the corrupted tails and their MRR. Parameters: ent,
    rel (Embedding tables) and w_rel [R, dim, dim], glorot-uniform with
    flax's fans (R counts as the receptive field)."""

    def __init__(self, num_entities: int, num_relations: int, dim: int,
                 num_rel_sample: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_rel_sample = int(num_rel_sample)
        self.ent = Embedding(num_entities, dim, generator=generator)
        self.rel = Embedding(num_relations, dim, generator=generator)
        self.w_rel = nn.Parameter(glorot_uniform(
            (self.num_rel_sample, dim, dim), generator))

    def encode(self, ids: torch.Tensor, nbr_ids: torch.Tensor) -> torch.Tensor:
        """ids [B], nbr_ids [R, B, K] → [B, dim]."""
        h = self.ent(ids)
        nbr = self.ent(nbr_ids).mean(2)                      # [R, B, D]
        msg = torch.einsum("rbd,rde->be", nbr, self.w_rel) \
            / self.num_rel_sample
        return torch.relu(h + msg)

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        h = self.encode(batch["h"], batch["h_nbrs"])
        t = self.ent(batch["t"])
        neg_t = self.ent(batch["neg_t"])                     # [B, N, D]
        r = self.rel(batch["r"])
        pos = (h * r * t).sum(-1, keepdim=True)
        neg = torch.einsum("bd,bnd->bn", h * r, neg_t)
        loss = torch.clamp(1.0 - pos + neg, min=0.0).mean()
        scores = torch.cat([pos, neg], dim=1)
        return ModelOutput(h, loss, "mrr", M.mrr(scores))


def rgcn_input_fn(graph, num_entities: int, num_relations: int,
                  batch_size: int, fanout: int, num_rel_sample: int,
                  num_negs: int, rng: np.random.Generator):
    """The runner's input, the reference's draws in its order: the
    triples, the relations, each relation's neighbor draw, the
    corruptions."""
    rel_pool = np.arange(num_relations)

    def input_fn() -> Iterator[Dict[str, Any]]:
        while True:
            h, t, r = graph.sample_edge(batch_size, -1)
            rels = rng.choice(rel_pool, num_rel_sample,
                              replace=num_relations < num_rel_sample)
            nbrs = []
            for rr in rels:
                nb, _, _ = graph.sample_neighbor(h, fanout,
                                                 edge_types=[int(rr)])
                nbrs.append(nb)
            neg_t = rng.integers(0, num_entities, (batch_size, num_negs))
            yield {"h": h.astype(np.int64), "t": t.astype(np.int64),
                   "r": r.astype(np.int32),
                   "h_nbrs": np.stack(nbrs).astype(np.int64),
                   "neg_t": neg_t.astype(np.int64), "infer_ids": h}

    return input_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="fb15k237")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--fanout", type=int, default=8)
    ap.add_argument("--num_rel_sample", type=int, default=8,
                    help="relations sampled per batch for aggregation")
    ap.add_argument("--num_negs", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=300)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def rgcn_estimator(args, kg, dev):
    """(BaseEstimator, input_fn): RGCNLinkModel over the KGData kg on
    dev, and its batch stream (numpy's default_rng(args.seed))."""
    model = RGCNLinkModel(kg.num_entities, kg.num_relations, args.dim,
                          args.num_rel_sample,
                          generator=torch.Generator().manual_seed(args.seed))
    est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                    seed=args.seed),
                        model_dir=args.model_dir or None, device=dev)
    return est, rgcn_input_fn(kg.engine, kg.num_entities, kg.num_relations,
                              args.batch_size, args.fanout,
                              args.num_rel_sample, args.num_negs,
                              np.random.default_rng(args.seed))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    kg = load_graph(args.dataset, args.seed)
    est, input_fn = rgcn_estimator(args, kg, dev)
    res = train_then_evaluate(est, input_fn, args.max_steps,
                              args.eval_steps)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
