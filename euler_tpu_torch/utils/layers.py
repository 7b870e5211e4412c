"""Dense and Embedding layers with flax's initialisation (counterpart of
euler_tpu/utils/layers.py:24-57, whose Dense is flax.linen.Dense).

The weight is kept [out, in] as torch.nn.Linear keeps it; flax keeps its
kernel [in, out], and euler_tpu_torch.convert transposes between them.
An Embedding's table has the same layout in both.
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


def bucketize_ids(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Node ids → table rows: ids as int32, then modulo num_buckets with
    the sign of the divisor (floor mod, as jnp's `%`), so a negative id
    wraps into [0, num_buckets). Counterpart of
    euler_tpu/utils/layers.py:bucketize_ids."""
    return torch.remainder(ids.to(torch.int32), num_buckets)


class Embedding(nn.Module):
    """Node-id embedding table [num_embeddings, dim] (parameter "table",
    flax's name). Fresh init matches flax's
    `nn.initializers.uniform(scale=init_scale)`: U[0, init_scale), not
    ±init_scale, drawn from the caller's generator (CPU).

    The lookup's gradient is dense, a [num_embeddings, dim] tensor, as
    the reference's jnp.take gradient is: the optimizers of
    utils/optimizers.py then decay every row's moments every step, as
    optax's do. A sparse gradient (nn.Embedding(sparse=True)) with a
    lazy optimizer would take other steps."""

    def __init__(self, num_embeddings: int, dim: int,
                 init_scale: float = 0.05,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.table = nn.Parameter(
            torch.rand((self.num_embeddings, dim), generator=generator)
            * init_scale)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = bucketize_ids(ids, self.num_embeddings)
        return F.embedding(rows.long(), self.table)
