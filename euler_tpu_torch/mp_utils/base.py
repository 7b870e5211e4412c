"""Model contract: (embedding, loss, metric_name, metric) — counterpart
of euler_tpu/mp_utils/base.py:24-142 (ModelOutput, SuperviseModel,
UnsuperviseModel).

A model takes a batch dict of tensors already on its device and returns
a ModelOutput. Dropout (base.py:41-62) acts on the embedding before the
logits, only in training mode (`model.train()`), with a mask drawn from
the batch's `dropout_generator`: the estimator makes one per step,
seeded from (seed + 1, step) as the reference folds the step into
key(seed + 1). There is no global RNG; the mask's bits are torch's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import Dense, Embedding, dropout
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy


class ModelOutput(NamedTuple):
    embedding: torch.Tensor
    loss: torch.Tensor
    metric_name: str
    metric: torch.Tensor


class SuperviseModel(nn.Module):
    """Supervised node classification: embed → dense logits ("out") →
    cross-entropy. multilabel: sigmoid BCE summed over classes and
    micro-F1 over thresholded probabilities; else softmax cross-entropy
    on one-hot [B, C] or integer [B] labels and micro-F1 of the argmax.

    Labels come from batch["labels"], else from the device label table
    at the root rows (a row-sharded label table, through
    make_table_gather, reads as the whole one). An optional [B] 0/1 batch["metric_mask"] drops
    padded rows from the loss mean and the metric counts."""

    def __init__(self, num_classes: int, multilabel: bool, emb_dim: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.num_classes = int(num_classes)
        self.multilabel = bool(multilabel)
        self.dropout = float(dropout)
        # the mesh whose 'model' axis row-shards the device tables (None:
        # replicated tables, local takes); subclasses that read tables
        # set it
        self.table_mesh = None
        self.out = Dense(emb_dim, num_classes, generator=generator)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.embed(batch)
        if self.dropout > 0.0 and self.training:
            emb = dropout(emb, self.dropout, batch.get("dropout_generator"),
                          batch_dim=0)
        labels = batch.get("labels")
        if labels is None:
            from euler_tpu_torch.parallel.device_sampler import (
                make_table_gather, read_rows,
            )

            table, roots = batch["label_table"], batch["rows"][0]
            labels = make_table_gather(self.table_mesh)(table, roots) \
                if self.table_mesh is not None else read_rows(table, roots)
        logits = self.out(emb)
        mask = batch.get("metric_mask")
        if self.multilabel:
            per_row = F.binary_cross_entropy_with_logits(
                logits, labels.to(torch.float32), reduction="none").sum(-1)
            metric = M.micro_f1(torch.sigmoid(logits), labels, mask=mask)
        else:
            if labels.dim() == logits.dim():
                per_row = -(labels.to(torch.float32)
                            * F.log_softmax(logits, dim=-1)).sum(-1)
                int_labels = labels.argmax(-1)
            else:
                int_labels = labels.long()
                per_row = F.cross_entropy(logits, int_labels,
                                          reduction="none")
            metric = M.micro_f1(logits, int_labels, mask=mask)
        return ModelOutput(emb, M.masked_mean(per_row, mask), "f1", metric)


def ranking_loss(emb: torch.Tensor, ctx: torch.Tensor,
                 valid: Optional[torch.Tensor] = None):
    """Negative-sampling loss and MRR of embeddings emb [B, D] against
    contexts ctx [B, 1 + num_negs, D], the positive first: the sigmoid
    BCE of the positive's logit against 1 plus that of the negatives'
    against 0, each averaged over its row and then over the rows where
    valid (0/1 [B]) is set (all rows when valid is None). Returns
    (loss, mrr)."""
    scores = torch.einsum("bd,bkd->bk", emb, ctx)
    pos, neg = scores[:, :1], scores[:, 1:]
    loss = (M.masked_mean(sigmoid_binary_cross_entropy(
                pos, torch.ones_like(pos)).mean(-1), valid)
            + M.masked_mean(sigmoid_binary_cross_entropy(
                neg, torch.zeros_like(neg)).mean(-1), valid))
    return loss, M.mrr(scores, valid)


class UnsuperviseModel(nn.Module):
    """Unsupervised embedding with negative sampling: a positive context
    and num_negs sampled negatives per source, sigmoid BCE, MRR metric.

    Subclasses define embed(batch) → [B, D]; the contexts batch["pos"]
    [B] (or [B, 1]) and batch["negs"] [B, num_negs] are ids looked up in
    one shared table, ctx_emb [max_id + 1, dim], unless a subclass
    overrides context_embed(pos, negs). The batches come from the host
    (the graph engine's pairs, EdgeEstimator's): ids arrive as int32
    rows, bucketized by the table's height (models/graphsage.py
    UnsupervisedGraphSage)."""

    def __init__(self, dim: int, max_id: int, num_negs: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = int(dim)
        self.max_id = int(max_id)
        self.num_negs = int(num_negs)
        self.ctx_emb = Embedding(self.max_id + 1, self.dim,
                                 generator=generator)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def context_embed(self, pos: torch.Tensor, negs: torch.Tensor):
        return self.ctx_emb(pos), self.ctx_emb(negs)

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.embed(batch)
        pos, negs = self.context_embed(batch["pos"], batch["negs"])
        if pos.dim() == 2:
            pos = pos[:, None, :]
        loss, metric = ranking_loss(emb, torch.cat([pos, negs], dim=1))
        return ModelOutput(emb, loss, "mrr", metric)
