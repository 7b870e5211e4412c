"""Relational convolution, R-GCN style (counterpart of
euler_tpu/convolution/relation_conv.py:15-53)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.convolution.gat_conv import glorot_uniform
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class RelationConv(nn.Module):
    """x'_i = lin_root(x_i) + Σ_r Σ_{j ∈ N_r(i)} (1 / c_{i,r}) x_j W_r.

    edge_type: [E] relation per edge (all 0 when None). The weights are
    one stacked tensor w_rel [R, in_dim, out_dim], glorot-uniform with
    flax's fans (R counts as the receptive field: fan_in = R·in_dim,
    fan_out = R·out_dim); each edge's message is its source row times
    its relation's matrix, and c_{i,r} counts i's in-edges of relation
    r. The per-edge weights and the source rows are gathered through
    mp_ops.gather, whose gradient sums in the same order every run."""

    def __init__(self, in_dim: int, out_dim: int, num_relations: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.num_relations = int(num_relations)
        self.w_rel = nn.Parameter(glorot_uniform(
            (self.num_relations, in_dim, self.out_dim), generator))
        self.lin_root = Dense(in_dim, self.out_dim, use_bias=use_bias,
                              generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                edge_type: Optional[torch.Tensor] = None,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        if edge_type is None:
            edge_type = torch.zeros(edge_index.shape[1], dtype=torch.int32,
                                    device=edge_index.device)
        src, dst = edge_index[0], edge_index[1]
        msgs = mp.gather(x_src, src)                      # [E, D_in]
        w_e = mp.gather(self.w_rel, edge_type)            # [E, D_in, D_out]
        msgs = torch.einsum("ed,edo->eo", msgs, w_e)
        # the mean within (dst, relation)
        seg = dst.long() * self.num_relations + edge_type.long()
        cnt = mp.segment_count(seg, n * self.num_relations)
        msgs = msgs / torch.clamp(mp.gather(cnt, seg), min=1.0)[:, None]
        agg = mp.scatter_add(msgs, dst, n)
        return agg + self.lin_root(x_tgt[:n])
