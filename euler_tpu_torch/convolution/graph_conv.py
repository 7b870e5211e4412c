"""GraphConv layer, Morris et al.'s weighted sum (counterpart of
euler_tpu/convolution/graph_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, aggregate, split_x
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class GraphConv(nn.Module):
    """x' = W1 x + W2 · aggr_{j∈N(i)} w_ij x_j (lin_root, lin_nbr)."""

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "add",
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.aggr = aggr
        self.lin_root = Dense(in_dim, out_dim, use_bias=use_bias,
                              generator=generator)
        self.lin_nbr = Dense(in_dim, out_dim, use_bias=False,
                             generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        msgs = mp.gather(x_src, edge_index[0])
        if edge_weight is not None:
            msgs = msgs * edge_weight[:, None]
        agg = aggregate(msgs, edge_index[1], n, self.aggr)
        return self.lin_root(x_tgt[:n]) + self.lin_nbr(agg)
