"""GCN layer, Kipf & Welling (counterpart of
euler_tpu/convolution/gcn_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class GCNConv(nn.Module):
    """x' = D̂^{-1/2} Â D̂^{-1/2} x W with the self-loops folded in: each
    node's own transformed row joins the sum at 1/d̂_dst, so edge_index
    is never extended. On a bipartite block the norm is 1/d̂_dst per
    incoming edge (row normalization)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.lin = Dense(in_dim, out_dim, use_bias=False,
                         generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        bipartite = x_src is not x_tgt
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        h_src = self.lin(x_src)
        h_tgt = self.lin(x_tgt) if bipartite else h_src
        src, dst = edge_index[0], edge_index[1]
        deg_dst = mp.segment_count(dst, n) + 1.0
        self_norm = 1.0 / deg_dst
        if bipartite:
            norm = self_norm[dst.long()]
        else:
            deg_src = mp.segment_count(src, x_src.shape[0]) + 1.0
            norm = (torch.rsqrt(deg_src)[src.long()]
                    * torch.rsqrt(deg_dst)[dst.long()])
        out = mp.scatter_add(mp.gather(h_src, src) * norm[:, None], dst, n)
        out = out + h_tgt[:n] * self_norm[:, None]
        if self.bias is not None:
            out = out + self.bias
        return out
