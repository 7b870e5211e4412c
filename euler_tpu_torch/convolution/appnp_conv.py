"""APPNP layer, personalized-PageRank propagation (counterpart of
euler_tpu/convolution/appnp_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import (
    XInput, propagate, shared_only, sym_norm,
)


class APPNPConv(nn.Module):
    """z^{k+1} = (1 - α) Â z^k + α h for K steps from z^0 = h, the input
    prediction; the reference's lax.scan is a Python loop. No
    parameters; the width is kept."""

    def __init__(self, k_hop: int = 10, alpha: float = 0.1):
        super().__init__()
        self.k_hop, self.alpha = int(k_hop), float(alpha)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        h = shared_only(x, "APPNPConv")
        n = num_nodes if num_nodes is not None else h.shape[0]
        norm, self_norm = sym_norm(edge_index, n)
        z = h
        for _ in range(self.k_hop):
            z = ((1.0 - self.alpha)
                 * (propagate(z, edge_index, n, norm)
                    + z * self_norm[:, None])
                 + self.alpha * h)
        return z
