"""DNA layer, dynamic neighborhood aggregation, Fey 2019 (counterpart
of euler_tpu/convolution/dna_conv.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense


class DNAConv(nn.Module):
    """Attention over each neighbor's layer history: x is the stacked
    history [N, T, D]; per edge (and a virtual self-loop per node) the
    destination's latest layer is the query (q), the source's whole
    history the keys (k) and values (v), a scaled dot-product softmax
    over T; the per-edge results are averaged into each destination."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim, self.heads = int(out_dim), int(heads)
        for name in ("q", "k", "v"):
            self.add_module(name, Dense(in_dim, out_dim, use_bias=False,
                                        generator=generator))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError("DNAConv expects stacked history [N, T, D]")
        n = num_nodes if num_nodes is not None else x.shape[0]
        N, T, _ = x.shape
        H = self.heads
        dh = self.out_dim // H
        loop = torch.arange(n, device=edge_index.device)
        src = torch.cat([edge_index[0].long(), loop])
        dst = torch.cat([edge_index[1].long(), loop])
        q = mp.gather(self.q(x[:, -1, :]).reshape(N, H, dh), dst)
        k = mp.gather(self.k(x).reshape(N, T, H, dh), src)  # [E, T, H, dh]
        v = mp.gather(self.v(x).reshape(N, T, H, dh), src)
        logits = (k * q[:, None]).sum(-1) / math.sqrt(float(dh))
        att = torch.softmax(logits, dim=1)                    # [E, T, H]
        per_edge = (att[..., None] * v).sum(dim=1).reshape(-1, self.out_dim)
        return mp.scatter_mean(per_edge, dst, n)
