"""Model contract: (embedding, loss, metric_name, metric) — counterpart
of euler_tpu/mp_utils/base.py:24-96 (ModelOutput, SuperviseModel).

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
from euler_tpu_torch.utils.layers import Dense


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
    at the root rows. An optional [B] 0/1 batch["metric_mask"] drops
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
        self.out = Dense(emb_dim, num_classes, generator=generator)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        raise NotImplementedError

    def _drop(self, emb: torch.Tensor, gen: Optional[torch.Generator]
              ) -> torch.Tensor:
        """flax nn.Dropout: keep with probability 1-p, scale kept units
        by 1/(1-p)."""
        if gen is None:
            raise ValueError("dropout in training mode needs the batch's "
                             "dropout_generator (the estimator's step "
                             "stream)")
        keep_p = 1.0 - self.dropout
        u = torch.rand(emb.shape, generator=gen, device=emb.device)
        return torch.where(u < keep_p, emb / keep_p, torch.zeros_like(emb))

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.embed(batch)
        if self.dropout > 0.0 and self.training:
            emb = self._drop(emb, batch.get("dropout_generator"))
        labels = batch.get("labels")
        if labels is None:
            labels = batch["label_table"][batch["rows"][0].long()]
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
