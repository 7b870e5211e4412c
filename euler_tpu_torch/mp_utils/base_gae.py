"""Graph auto-encoders, GAE and VGAE (counterpart of
euler_tpu/mp_utils/base_gae.py:24-61): a conv-stack encoder over the
whole node table, an inner-product decoder, and the reconstruction loss
over positive edges and sampled negative pairs; VGAE adds the KL term.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import Dense
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy


class BaseGraphGAE(nn.Module):
    """batch: x [N, D] / edge_index [2, E], the whole node table (any
    root_index is ignored), and pos_src / pos_dst / neg_src / neg_dst,
    rows of the table. BaseGNNNet "enc" embeds every node; the scores
    are the inner products of the pairs' embeddings; the loss is the
    mean sigmoid cross-entropy of the positives against 1 plus the
    negatives' against 0 (+ 0.001 KL for VGAE); the metric is the AUC of
    the scores.

    variational: Dense "mu" and "logvar" on the encoding, and the
    embedding μ + exp(logvar / 2)·ε with ε the batch's "eps" [N, dim],
    or drawn from its "noise_generator" in training mode, else μ. The
    reference draws ε only when its caller gives a "sample" rng, which
    its estimator never does, so its training and evaluation use μ; the
    port's estimator gives no noise_generator either."""

    def __init__(self, in_dim: int, conv_name: str = "gcn", dim: int = 32,
                 num_layers: int = 2, variational: bool = False,
                 conv_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.variational = bool(variational)
        self.enc = BaseGNNNet(conv_name, in_dim, dim, num_layers,
                              conv_kwargs=conv_kwargs, generator=generator)
        if self.variational:
            self.mu = Dense(self.enc.out_dim, dim, generator=generator)
            self.logvar = Dense(self.enc.out_dim, dim, generator=generator)

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        sub = {k: v for k, v in batch.items() if k != "root_index"}
        h = self.enc(sub)
        kl = 0.0
        if self.variational:
            mu, logvar = self.mu(h), self.logvar(h)
            eps = batch.get("eps")
            gen = batch.get("noise_generator")
            if eps is None and gen is not None and self.training:
                eps = torch.randn(mu.shape, generator=gen, device=mu.device)
            h = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
            kl = -0.5 * torch.mean(torch.sum(
                1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
        pos = (mp.gather(h, batch["pos_src"])
               * mp.gather(h, batch["pos_dst"])).sum(-1)
        neg = (mp.gather(h, batch["neg_src"])
               * mp.gather(h, batch["neg_dst"])).sum(-1)
        loss = (sigmoid_binary_cross_entropy(pos, torch.ones_like(pos)).mean()
                + sigmoid_binary_cross_entropy(
                    neg, torch.zeros_like(neg)).mean()
                + 0.001 * kl)
        scores = torch.cat([pos, neg])
        labels = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        return ModelOutput(h, loss, "auc", M.auc(scores.detach(), labels))
