"""Losses the port needs from optax, written out in PyTorch."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Elementwise -y·log σ(x) - (1-y)·log σ(-x), optax's formula and
    order (optax.sigmoid_binary_cross_entropy): each log-sigmoid is the
    stable one, so a large |x| gives |x|, not inf."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)
