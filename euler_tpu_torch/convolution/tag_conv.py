"""TAGCN layer, the topology-adaptive GCN (counterpart of
euler_tpu/convolution/tag_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import (
    XInput, propagate, shared_only, sym_norm,
)
from euler_tpu_torch.utils.layers import Dense


class TAGConv(nn.Module):
    """x' = Σ_{k=0..K} Â^k x W_k: a linear filter per power (lin_k, no
    bias) and one `bias` [out_dim]."""

    def __init__(self, in_dim: int, out_dim: int, k_hop: int = 3,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.k_hop = int(k_hop)
        for k in range(self.k_hop + 1):
            self.add_module(f"lin_{k}", Dense(in_dim, out_dim,
                                              use_bias=False,
                                              generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        z = shared_only(x, "TAGConv")
        n = num_nodes if num_nodes is not None else z.shape[0]
        norm, self_norm = sym_norm(edge_index, n)
        out = self.lin_0(z)
        for k in range(1, self.k_hop + 1):
            z = propagate(z, edge_index, n, norm) + z * self_norm[:, None]
            out = out + getattr(self, f"lin_{k}")(z)
        if self.bias is not None:
            out = out + self.bias
        return out
