"""ARMA layer, the auto-regressive moving-average graph filter
(counterpart of euler_tpu/convolution/arma_conv.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.convolution.conv import (
    XInput, propagate, shared_only, sym_norm,
)
from euler_tpu_torch.utils.layers import Dense


class ARMAConv(nn.Module):
    """num_stacks parallel ARMA_1 stacks of depth num_layers, averaged:
    z^{t+1} = relu(L̂ z^t W + x V), with W `w_{s}_{t}` (bias) and V
    `v_{s}_{t}` (no bias). The reference's dropout field is not used
    by its layer, and is not taken here."""

    def __init__(self, in_dim: int, out_dim: int, num_stacks: int = 1,
                 num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(out_dim)
        self.num_stacks, self.num_layers = int(num_stacks), int(num_layers)
        for s in range(self.num_stacks):
            for t in range(self.num_layers):
                self.add_module(f"v_{s}_{t}", Dense(
                    in_dim, out_dim, use_bias=False, generator=generator))
                self.add_module(f"w_{s}_{t}", Dense(
                    in_dim if t == 0 else out_dim, out_dim,
                    generator=generator))

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x = shared_only(x, "ARMAConv")
        n = num_nodes if num_nodes is not None else x.shape[0]
        norm, _ = sym_norm(edge_index, n)
        stacks = []
        for s in range(self.num_stacks):
            z = x
            for t in range(self.num_layers):
                root = getattr(self, f"v_{s}_{t}")(x)
                z = getattr(self, f"w_{s}_{t}")(z)
                z = torch.relu(propagate(z, edge_index, n, norm) + root)
            stacks.append(z)
        return torch.stack(stacks).mean(dim=0)
