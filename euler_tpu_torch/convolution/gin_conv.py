"""GIN layer, the graph isomorphism network (counterpart of
euler_tpu/convolution/gin_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class GINConv(nn.Module):
    """x' = MLP((1 + ε) x + Σ_{j∈N(i)} x_j), a two-layer MLP (mlp_0,
    relu, mlp_1); ε a learned `eps` [1] (starting at eps) when
    train_eps."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 0,
                 eps: float = 0.0, train_eps: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        hidden = hidden_dim or out_dim
        self.eps = (nn.Parameter(torch.full((1,), float(eps)))
                    if train_eps else float(eps))
        self.mlp_0 = Dense(in_dim, hidden, generator=generator)
        self.mlp_1 = Dense(hidden, out_dim, generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        agg = mp.scatter_add(mp.gather(x_src, edge_index[0]),
                             edge_index[1], n)
        eps = self.eps[0] if isinstance(self.eps, torch.Tensor) else self.eps
        h = (1.0 + eps) * x_tgt[:n] + agg
        return self.mlp_1(torch.relu(self.mlp_0(h)))
