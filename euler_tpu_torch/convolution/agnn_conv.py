"""AGNN layer, attention-based propagation (counterpart of
euler_tpu/convolution/agnn_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import XInput, split_x
from euler_tpu_torch.ops import mp_ops as mp


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class AGNNConv(nn.Module):
    """Propagation P with P_ij = softmax_j(β cos(x_i, x_j)) over the
    edges and a virtual self-loop per node; β a learned scalar (`beta`,
    [1], starting at 1) when requires_grad, else 1. The width is kept:
    out_dim = in_dim."""

    def __init__(self, in_dim: int, requires_grad: bool = True):
        super().__init__()
        self.out_dim = int(in_dim)
        self.beta = nn.Parameter(torch.ones(1)) if requires_grad else None

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        norm_src, norm_tgt = _unit_rows(x_src), _unit_rows(x_tgt)
        src, dst = edge_index[0].long(), edge_index[1].long()
        cos = (mp.gather(norm_src, src) * mp.gather(norm_tgt, dst)).sum(-1)
        logits = torch.cat([cos, torch.ones(n, dtype=cos.dtype,
                                            device=cos.device)])
        if self.beta is not None:
            logits = self.beta[0] * logits
        index = torch.cat([dst, torch.arange(n, device=dst.device)])
        att = mp.scatter_softmax(logits, index, n)
        msgs = torch.cat([mp.gather(x_src, src), x_tgt[:n]])
        return mp.scatter_add(msgs * att[:, None], index, n)
