"""Composable pipelines, the "solution" layer (counterpart of
euler_tpu/solution/base_solution.py): logits heads, losses, a
positive/negative sampler, and the supervised and unsupervised
solutions that wire roots → FanoutDataFlow → SageEncoder → head → loss
and give estimator-ready input_fns.

The input_fns call the engine in the reference's order (sample_node,
the flow's sample_fanout and features, then the labels or the sampler's
sample_neighbor and sample_node), so under the same engine seed the
batches are the reference's, array for array. The models' parameters
keep the reference's names (enc, head/logits, ctx), so
euler_tpu_torch.convert maps the trees.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.encoders import SageEncoder
from euler_tpu_torch.utils.layers import Dense, Embedding
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy


# ---- logits heads ----
class DenseLogits(nn.Module):
    """logits = Dense(emb) (the Dense named "logits")."""

    def __init__(self, in_dim: int, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.logits = Dense(in_dim, num_classes, generator=generator)

    def forward(self, emb: torch.Tensor,
                ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.logits(emb)


class PosNegLogits(nn.Module):
    """Dot-product scores of emb [B, D] against pos [B, P, D] and negs
    [B, N, D]."""

    def forward(self, emb: torch.Tensor, pos: torch.Tensor,
                negs: torch.Tensor):
        return (torch.einsum("bd,bkd->bk", emb, pos),
                torch.einsum("bd,bkd->bk", emb, negs))


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v over its L2 norm (sqrt of the sum of squares, as
    jnp.linalg.norm), the norm at least 1e-12."""
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(norm, min=1e-12)


class CosineLogits(nn.Module):
    """scale · cosine similarity of emb with pos and negs (scale 10)."""

    def __init__(self, scale: float = 10.0):
        super().__init__()
        self.scale = float(scale)

    def forward(self, emb: torch.Tensor, pos: torch.Tensor,
                negs: torch.Tensor):
        emb, pos, negs = _unit(emb), _unit(pos), _unit(negs)
        return (self.scale * torch.einsum("bd,bkd->bk", emb, pos),
                self.scale * torch.einsum("bd,bkd->bk", emb, negs))


# ---- losses ----
def sigmoid_loss(pos_logit: torch.Tensor,
                 neg_logit: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE of the positives against 1 plus that of the
    negatives against 0."""
    return (sigmoid_binary_cross_entropy(
                pos_logit, torch.ones_like(pos_logit)).mean()
            + sigmoid_binary_cross_entropy(
                neg_logit, torch.zeros_like(neg_logit)).mean())


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy: one-hot (or soft) labels of the
    logits' rank, else integer labels."""
    if labels.dim() == logits.dim():
        return -(labels.to(torch.float32)
                 * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    return F.cross_entropy(logits, labels.long())


# ---- samplers ----
class PosNegSampler:
    """Positives from each root's neighbors (optionally typed edges),
    negatives from the engine's node sampler (node type neg_node_type,
    -1 for every node)."""

    def __init__(self, graph, num_negs: int = 5, pos_edge_types=None,
                 neg_node_type: int = -1):
        self.graph = graph
        self.num_negs = num_negs
        self.pos_edge_types = pos_edge_types
        self.neg_node_type = neg_node_type

    def __call__(self, roots: np.ndarray) -> Dict[str, np.ndarray]:
        pos, _, _ = self.graph.sample_neighbor(
            roots, 1, edge_types=self.pos_edge_types)
        negs = self.graph.sample_node(
            len(roots) * self.num_negs, self.neg_node_type
        ).reshape(len(roots), self.num_negs)
        return {"pos": pos[:, 0], "negs": negs}


# ---- models ----
class _SageSupModel(nn.Module):
    """SageEncoder ("enc", mean aggregator, concat) → DenseLogits
    ("head"): sigmoid BCE summed over classes and micro-F1 of the
    probabilities when multilabel, else softmax cross-entropy and
    micro-F1 of the argmax."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 num_classes: int, multilabel: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.multilabel = bool(multilabel)
        self.enc = SageEncoder(in_dim, dim, fanouts, generator=generator)
        self.head = DenseLogits(self.enc.out_dim, num_classes,
                                generator=generator)

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.enc(batch["layers"])
        logits = self.head(emb)
        labels = batch["labels"]
        if self.multilabel:
            loss = sigmoid_binary_cross_entropy(
                logits, labels.to(torch.float32)).sum(-1).mean()
            metric = M.micro_f1(torch.sigmoid(logits), labels)
        else:
            loss = xent_loss(logits, labels)
            metric = M.micro_f1(
                logits, labels.argmax(-1) if labels.dim() > 1 else labels)
        return ModelOutput(emb, loss, "f1", metric)


class _SageUnsupModel(nn.Module):
    """SageEncoder ("enc", concat=False) against the context table
    ("ctx", [max_id + 1, dim]) through a dot or cosine head ("head", no
    parameters): sigmoid loss and the MRR of the positive."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 max_id: int, logits_name: str = "dot",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc = SageEncoder(in_dim, dim, fanouts, concat=False,
                               generator=generator)
        self.ctx = Embedding(max_id + 1, dim, generator=generator)
        self.head = (CosineLogits() if logits_name == "cosine"
                     else PosNegLogits())

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.enc(batch["layers"])
        pos = self.ctx(batch["pos"])[:, None, :]
        negs = self.ctx(batch["negs"])
        pos_logit, neg_logit = self.head(emb, pos, negs)
        loss = sigmoid_loss(pos_logit, neg_logit)
        scores = torch.cat([pos_logit, neg_logit], dim=1)
        return ModelOutput(emb, loss, "mrr", M.mrr(scores))


def _in_dim(graph, feature_ids: Sequence) -> int:
    """The width of the concatenated dense features (flax infers it at
    init)."""
    return sum(graph.feature_dim(f) for f in feature_ids)


# ---- solutions ----
class SuperviseSolution:
    """Supervised node classification assembled from parts: roots of
    train_node_type from the engine, their fanout and features, their
    dense labels."""

    def __init__(self, graph, fanouts=(10, 10), dim=64, num_classes=2,
                 multilabel=False, feature_ids=("feature",),
                 label_fid="label", batch_size=64, train_node_type=0,
                 generator: Optional[torch.Generator] = None):
        self.graph = graph
        self.flow = FanoutDataFlow(graph, list(fanouts),
                                   feature_ids=list(feature_ids))
        self.model = _SageSupModel(_in_dim(graph, feature_ids), dim,
                                   tuple(fanouts), num_classes, multilabel,
                                   generator=generator)
        self.label_fid = label_fid
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.train_node_type = train_node_type

    def input_fn(self, node_type: Optional[int] = None) -> Iterator[Dict]:
        nt = self.train_node_type if node_type is None else node_type
        while True:
            roots = self.graph.sample_node(self.batch_size, nt)
            batch = self.flow(roots)
            batch["labels"] = self.graph.get_dense_feature(
                roots, self.label_fid, self.num_classes)
            batch["infer_ids"] = roots
            yield batch


class UnsuperviseSolution:
    """Unsupervised embedding learning assembled from parts: roots over
    every node, their fanout and features, a positive neighbor and
    num_negs negatives (PosNegSampler)."""

    def __init__(self, graph, fanouts=(10, 10), dim=64, max_id=0,
                 num_negs=5, feature_ids=("feature",), batch_size=64,
                 logits="dot", pos_edge_types=None,
                 generator: Optional[torch.Generator] = None):
        self.graph = graph
        self.flow = FanoutDataFlow(graph, list(fanouts),
                                   feature_ids=list(feature_ids))
        self.sampler = PosNegSampler(graph, num_negs, pos_edge_types)
        self.model = _SageUnsupModel(_in_dim(graph, feature_ids), dim,
                                     tuple(fanouts), max_id, logits,
                                     generator=generator)
        self.batch_size = batch_size

    def input_fn(self) -> Iterator[Dict]:
        while True:
            roots = self.graph.sample_node(self.batch_size, -1)
            batch = self.flow(roots)
            batch.update(self.sampler(roots))
            batch["infer_ids"] = roots
            yield batch
