"""Dense layer with flax's initialisation (counterpart of
euler_tpu/utils/layers.py, whose Dense is flax.linen.Dense).

The weight is kept [out, in] as torch.nn.Linear keeps it; flax keeps its
kernel [in, out], and euler_tpu_torch.convert transposes between them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# flax lecun_normal = variance_scaling(1, "fan_in", "truncated_normal"):
# a normal truncated at ±2 std, rescaled by this constant (the std of a
# unit normal truncated to [-2, 2]) so the kept values have variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """y = x W^T + b. Fresh init matches flax.linen.Dense: lecun_normal
    weight, zero bias, drawn from the caller's generator (CPU)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        std = math.sqrt(1.0 / in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax promotes (input, kernel) to their result type: a bf16 or
        # int8-dequantized input meets float32 params in float32
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
