"""Deep Graph Infomax (counterpart of euler_tpu/models/dgi.py:23-59):
the encoder's embeddings of the graph and of a corruption of it (its
feature rows shuffled) scored against the graph's summary by a bilinear
discriminator."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import PReLU
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy


def _glorot_uniform(shape, generator: Optional[torch.Generator]):
    """flax's glorot_uniform for a [fan_in, fan_out] matrix:
    U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out))."""
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class DGI(nn.Module):
    """batch: x [N, D] / edge_index [2, E] and x_corrupt [N, D] (the
    rows of x permuted, made by the feeder). h = PReLU(BaseGNNNet
    "encoder"(x)) for both inputs (one encoder, one "PReLU_0"); the
    summary is sigmoid(mean of the real rows); each row's logit is
    h · disc · summary, disc [dim, dim] glorot-uniform. The loss is the
    mean sigmoid cross-entropy of the real rows against 1 plus the
    corrupted rows' against 0; the metric is the AUC; the embedding is
    the real rows'."""

    def __init__(self, in_dim: int, conv_name: str = "gcn", dim: int = 64,
                 num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = BaseGNNNet(conv_name, in_dim, dim, num_layers,
                                  generator=generator)
        self.add_module("PReLU_0", PReLU())
        self.disc = nn.Parameter(_glorot_uniform((dim, dim), generator))

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        act = getattr(self, "PReLU_0")
        sub = {k: v for k, v in batch.items() if k != "root_index"}
        h_real = act(self.encoder(sub))
        h_fake = act(self.encoder({**sub, "x": batch["x_corrupt"]}))
        summary = torch.sigmoid(h_real.mean(0))
        real_logit = h_real @ self.disc @ summary
        fake_logit = h_fake @ self.disc @ summary
        loss = (sigmoid_binary_cross_entropy(
                    real_logit, torch.ones_like(real_logit)).mean()
                + sigmoid_binary_cross_entropy(
                    fake_logit, torch.zeros_like(fake_logit)).mean())
        scores = torch.cat([real_logit, fake_logit])
        labels = torch.cat([torch.ones_like(real_logit),
                            torch.zeros_like(fake_logit)])
        return ModelOutput(h_real, loss, "auc",
                           M.auc(scores.detach(), labels))
