"""Simplified GCN (SGC) layer (counterpart of
euler_tpu/convolution/sgcn_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import (
    XInput, propagate, shared_only, sym_norm,
)
from euler_tpu_torch.utils.layers import Dense


class SGCNConv(nn.Module):
    """x' = Â^K x W: K propagation steps, then one linear layer."""

    def __init__(self, in_dim: int, out_dim: int, k_hop: int = 2,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.k_hop = int(k_hop)
        self.lin = Dense(in_dim, out_dim, use_bias=use_bias,
                         generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        z = shared_only(x, "SGCNConv")
        n = num_nodes if num_nodes is not None else z.shape[0]
        norm, self_norm = sym_norm(edge_index, n)
        for _ in range(self.k_hop):
            z = propagate(z, edge_index, n, norm) + z * self_norm[:, None]
        return self.lin(z)
