"""GAT layer, Veličković et al. (counterpart of
euler_tpu/convolution/gat_conv.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


def glorot_uniform(shape, generator: Optional[torch.Generator]
                   ) -> torch.Tensor:
    """flax's glorot_uniform: U(-l, l), l = sqrt(6 / (fan_in +
    fan_out)), fan_in = shape[-2] and fan_out = shape[-1], each times
    the product of the leading dims (flax's receptive field)."""
    field = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class GATConv(nn.Module):
    """Multi-head additive attention over the edges and a virtual
    self-loop per node; the heads concatenated (concat) or averaged.
    The attention vectors att_src / att_dst [1, H, D] start
    glorot-uniform, as flax's."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.dim = int(heads), int(out_dim)
        self.concat = bool(concat)
        self.negative_slope = float(negative_slope)
        self.out_dim = self.heads * self.dim if self.concat else self.dim
        self.lin = Dense(in_dim, self.heads * self.dim, use_bias=False,
                         generator=generator)
        self.att_src = nn.Parameter(
            glorot_uniform((1, self.heads, self.dim), generator))
        self.att_dst = nn.Parameter(
            glorot_uniform((1, self.heads, self.dim), generator))
        self.bias = nn.Parameter(torch.zeros(self.out_dim)) \
            if use_bias else None

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        shared = x_src is x_tgt
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        H, D = self.heads, self.dim
        h_src = self.lin(x_src).reshape(-1, H, D)
        h_tgt = h_src if shared else self.lin(x_tgt).reshape(-1, H, D)
        alpha_src = (h_src * self.att_src).sum(-1)          # [N_src, H]
        alpha_dst = (h_tgt * self.att_dst).sum(-1)          # [N_tgt, H]
        src, dst = edge_index[0].long(), edge_index[1].long()
        # a self-loop edge per node, appended virtually: the softmax runs
        # over the real edges and the node's own
        e_alpha = mp.gather(alpha_src, src) + mp.gather(alpha_dst, dst)
        s_alpha = (alpha_src[:n] + alpha_dst[:n] if shared
                   else alpha_dst[:n] * 2.0)
        logits = F.leaky_relu(torch.cat([e_alpha, s_alpha]),
                              self.negative_slope)          # [E + n, H]
        index = torch.cat([dst, torch.arange(n, device=dst.device)])
        att = mp.scatter_softmax(logits, index, n)
        msgs = torch.cat([mp.gather(h_src, src), h_tgt[:n]])  # [E + n, H, D]
        out = mp.scatter_add(msgs * att[:, :, None], index, n)
        out = out.reshape(n, H * D) if self.concat else out.mean(dim=1)
        if self.bias is not None:
            out = out + self.bias
        return out
