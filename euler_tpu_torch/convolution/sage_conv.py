"""GraphSAGE layer (counterpart of euler_tpu/convolution/sage_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class SAGEConv(nn.Module):
    """x' = W · concat(x_tgt, mean_{j∈N(i)} x_j), optionally L2
    normalized."""

    def __init__(self, in_dim: int, out_dim: int, normalize: bool = False,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.normalize = bool(normalize)
        self.lin = Dense(2 * in_dim, out_dim, use_bias=use_bias,
                         generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        nbr = mp.scatter_mean(mp.gather(x_src, edge_index[0]),
                              edge_index[1], n)
        out = self.lin(torch.cat([x_tgt[:n], nbr], dim=-1))
        if self.normalize:
            out = out / torch.linalg.norm(out, dim=-1,
                                          keepdim=True).clamp_min(1e-12)
        return out
