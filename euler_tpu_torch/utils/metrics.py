"""Model metrics (counterpart of euler_tpu/utils/metrics.py:19,55,79-97)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["masked_mean", "micro_f1", "mrr", "mr", "hit_at_k"]


def masked_mean(x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x over rows where mask (0/1, any shape raveling to [B])
    is set; the plain mean when mask is None."""
    if mask is None:
        return x.mean()
    m = mask.reshape(-1).to(torch.float32)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def micro_f1(logits: torch.Tensor, labels: torch.Tensor,
             threshold: float = 0.5,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Micro-averaged F1 for multilabel (thresholded) or multiclass
    (argmax vs integer labels) predictions. mask [B] (0/1) drops padded
    rows from every tp/fp/fn count."""
    if logits.dim() > 1 and labels.dim() == 1:
        c = logits.shape[-1]
        pred = F.one_hot(logits.argmax(-1), c).to(torch.float32)
        lab = F.one_hot(labels.long(), c).to(torch.float32)
    else:
        pred = (logits > threshold).to(torch.float32)
        lab = labels.to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32).reshape(
            tuple(mask.shape) + (1,) * (pred.dim() - mask.dim()))
        pred = pred * m
        lab = lab * m
    tp = (pred * lab).sum()
    fp = (pred * (1 - lab)).sum()
    fn = ((1 - pred) * lab).sum()
    return 2 * tp / (2 * tp + fp + fn).clamp_min(1.0)


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of column 0 (the positive) among all columns, per row:
    1 + the number of other columns scoring >= it (a tie counts
    against the positive). scores: [B, 1 + num_neg], higher is
    better."""
    return 1.0 + (scores[:, 1:] >= scores[:, :1]).sum(1).to(torch.float32)


def mrr(scores: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean reciprocal rank of column 0 over the rows where mask is
    set (every row when mask is None)."""
    return masked_mean(1.0 / _ranks(scores), mask)


def mr(scores: torch.Tensor) -> torch.Tensor:
    """Mean rank of column 0."""
    return _ranks(scores).mean()


def hit_at_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Share of rows whose column 0 ranks within the top k."""
    return (_ranks(scores) <= k).to(torch.float32).mean()
