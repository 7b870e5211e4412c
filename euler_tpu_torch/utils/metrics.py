"""Model metrics (counterpart of euler_tpu/utils/metrics.py:19-114):
accuracy, AUC, micro-F1, MRR, MR, hit@k and the name table get_metric."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["accuracy", "auc", "f1_score", "micro_f1", "mrr", "mr",
           "hit_at_k", "masked_mean", "get_metric"]


def masked_mean(x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of x over rows where mask (0/1, any shape raveling to [B])
    is set; the plain mean when mask is None."""
    if mask is None:
        return x.mean()
    m = mask.reshape(-1).to(torch.float32)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiclass (argmax over the last dim, against integer or one-hot
    labels) or binary (logits thresholded at 0.5) accuracy; mask [B]
    (0/1) leaves padded rows out of the mean."""
    if logits.dim() > 1 and logits.shape[-1] > 1:
        pred = logits.argmax(-1)
        lab = labels if labels.dim() == logits.dim() - 1 \
            else labels.argmax(-1)
        return masked_mean((pred == lab).to(torch.float32), mask)
    pred = (logits.reshape(-1) > 0.5).to(torch.int32)
    lab = labels.reshape(-1).to(torch.int32)
    return masked_mean((pred == lab).to(torch.float32), mask)


def auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Pairwise AUC from ranks: (sum of the positives' ranks - P(P+1)/2)
    / (P N). The ranks are positions in a stable ascending sort, as the
    reference's code ranks them (its docstring speaks of midranks, its
    code gives tied scores distinct ranks in index order)."""
    scores = scores.reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores).index_copy_(
        0, order, torch.arange(1, scores.shape[0] + 1, dtype=scores.dtype,
                               device=scores.device))
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    pos_rank_sum = (ranks * labels).sum()
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2) / (
        n_pos * n_neg).clamp_min(1.0)


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


f1_score = micro_f1


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


def get_metric(name: str):
    """The metric function of a name (the reference's table: acc,
    accuracy, auc, f1, micro_f1, mrr, mr, hit1, hit3, hit10)."""
    table = {
        "acc": accuracy, "accuracy": accuracy,
        "auc": auc,
        "f1": micro_f1, "micro_f1": micro_f1,
        "mrr": mrr, "mr": mr,
        "hit1": lambda s: hit_at_k(s, 1),
        "hit3": lambda s: hit_at_k(s, 3),
        "hit10": lambda s: hit_at_k(s, 10),
    }
    try:
        return table[name.lower()]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}") from None
