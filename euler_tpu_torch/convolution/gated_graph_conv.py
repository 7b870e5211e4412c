"""Gated graph convolution, GGNN (counterpart of
euler_tpu/convolution/gated_graph_conv.py:15-41)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, shared_only
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense, GRUCell


class GatedGraphConv(nn.Module):
    """h ← GRU(h, Σ_{j→i} w_t(h_j)) for t < num_layers, from h = x
    zero-padded to out_dim (an input wider than out_dim raises). The
    carry is h and the input the aggregate, as the reference calls
    `gru(h, agg)`; one cell ("gru") serves every step, each step has its
    own bias-free Dense w_{t}. Needs a shared node set."""

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_dim > out_dim:
            raise ValueError("input dim must be <= out_dim")
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.num_layers = int(num_layers)
        self.gru = GRUCell(out_dim, out_dim, generator=generator)
        for t in range(self.num_layers):
            self.add_module(f"w_{t}", Dense(out_dim, out_dim, use_bias=False,
                                            generator=generator))

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x = shared_only(x, "GatedGraphConv")
        n = num_nodes if num_nodes is not None else x.shape[0]
        if x.shape[-1] > self.out_dim:
            raise ValueError("input dim must be <= out_dim")
        h = F.pad(x, (0, self.out_dim - x.shape[-1]))
        src, dst = edge_index[0], edge_index[1]
        for t in range(self.num_layers):
            m = getattr(self, f"w_{t}")(h)
            agg = mp.scatter_add(mp.gather(m, src), dst, n)
            h = self.gru(h, agg)
        return h
