"""Dense, Embedding, SparseEmbedding, AttLayer and LSTMLayer with flax's
initialisation (counterpart of euler_tpu/utils/layers.py:24-118, whose Dense
is flax.linen.Dense and whose LSTM is flax's OptimizedLSTMCell under
nn.RNN), and flax's GRUCell and PReLU, which the reference's
GatedGraphConv and DGI use.

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

from euler_tpu_torch.parallel import collectives

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


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            batch_dim: Optional[int] = None) -> torch.Tensor:
    """flax nn.Dropout in training: keep each unit with probability
    1 - rate, scaled by 1 / (1 - rate), the mask drawn from `generator`
    (the batch's dropout_generator, the estimator's step stream). Its
    bits are torch's, not JAX's. batch_dim: x's dimension over batch
    rows, whose mask inside collectives.data_parallel is this rank's
    slice of the global batch's."""
    if generator is None:
        raise ValueError("dropout in training mode needs the batch's "
                         "dropout_generator (the estimator's step "
                         "stream)")
    keep_p = 1.0 - rate
    u = collectives.draw_rows(x.shape, generator, x.device, batch_dim)
    return torch.where(u < keep_p, x / keep_p, torch.zeros_like(x))


class Dropout(nn.Module):
    """flax nn.Dropout as a module: `dropout` (the rate) in training
    mode, the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.dropout = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.dropout <= 0.0 or not self.training:
            return x
        return dropout(x, self.dropout, generator)


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

    The lookup's gradient on a CUDA table is row-sparse: a sparse COO
    tensor of the ids looked up and their gradient rows (uncoalesced,
    nothing of the table's size; a table read twice in a step gets both
    lookups' rows), built with no host sync, so a CUDA graph captures
    it. The optimizers of utils/optimizers.py step it with dense
    semantics, the step they take on the dense gradient: Adam decays
    every row's moments every step, as optax's does on the reference's
    dense jnp.take gradient (a lazy optimizer, torch's SparseAdam, would
    take other steps). On a CPU table the gradient is the dense
    [num_embeddings, dim] tensor."""

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
        return F.embedding(rows.long(), self.table,
                           sparse=self.table.is_cuda)


class SparseEmbedding(nn.Module):
    """Embedding over padded variable-length sparse ids [B, L], combined
    over L (counterpart of euler_tpu/utils/layers.py:SparseEmbedding):
    the rows of bucketize_ids(ids), each masked to 0 where the id equals
    `pad_id`, then "sum", "max" or "mean" (the sum over the unmasked
    count, at least 1). "max" runs over the masked rows, so a pad slot
    counts as a row of zeros, and `amax` shares a tie's gradient
    equally, as jnp's max does. Parameter "table", initialised as
    Embedding's."""

    def __init__(self, num_embeddings: int, dim: int,
                 combiner: str = "mean", pad_id: int = 0,
                 init_scale: float = 0.05,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("mean", "sum", "max"):
            raise ValueError(f"combiner must be mean, sum or max, got "
                             f"{combiner!r}")
        self.num_embeddings = int(num_embeddings)
        self.combiner = combiner
        self.pad_id = int(pad_id)
        self.table = nn.Parameter(
            torch.rand((self.num_embeddings, dim), generator=generator)
            * init_scale)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = bucketize_ids(ids, self.num_embeddings)
        emb = F.embedding(rows.long(), self.table)          # [B, L, D]
        mask = (ids.to(torch.int32) != self.pad_id).to(emb.dtype)[..., None]
        emb = emb * mask
        if self.combiner == "sum":
            return emb.sum(1)
        if self.combiner == "max":
            return emb.amax(1)
        return emb.sum(1) / torch.clamp(mask.sum(1), min=1.0)


class AttLayer(nn.Module):
    """Single-query soft attention pooling over a set [B, L, D] → [B, D]
    (counterpart of euler_tpu/utils/layers.py:AttLayer): logits =
    tanh(key(x)) · query, a softmax over L, the weighted sum of x. The
    query [dim] starts as flax's normal(stddev=0.1)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.query = nn.Parameter(
            torch.randn((dim,), generator=generator) * 0.1)
        self.key = Dense(in_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        keys = self.key(x)                                  # [B, L, dim]
        logits = torch.einsum("bld,d->bl", torch.tanh(keys), self.query)
        att = torch.softmax(logits, dim=-1)
        return torch.einsum("bl,bld->bd", att, x.to(att.dtype))


class OptimizedLSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell with its parameters by name: input
    transforms ii/if/ig/io (no bias, lecun_normal) and recurrent ones
    hi/hf/hg/ho (bias, orthogonal init). As flax computes it, the four
    kernels of each side are applied as one concatenated matmul, then
    i, f, o = sigmoid(h-side + x-side), g = tanh(h-side + x-side),
    c' = f·c + i·g, h' = o·tanh(c')."""

    _GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = int(dim)
        for g in self._GATES:
            self.add_module(f"i{g}", Dense(in_dim, dim, use_bias=False,
                                           generator=generator))
        for g in self._GATES:
            lin = Dense(dim, dim, generator=generator)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
            self.add_module(f"h{g}", lin)

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        w_h = torch.cat([getattr(self, f"h{g}").weight
                         for g in self._GATES])
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in self._GATES])
        w_i = torch.cat([getattr(self, f"i{g}").weight
                         for g in self._GATES])
        dense_h = F.linear(h, w_h, b_h).split(self.dim, dim=-1)
        dense_i = F.linear(x.to(w_i.dtype), w_i).split(self.dim, dim=-1)
        i, f, g, o = (a + b for a, b in zip(dense_h, dense_i))
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(nn.Module):
    """flax.linen.GRUCell with its parameters by name: input transforms
    ir/iz/in (bias, lecun_normal) and recurrent ones hr/hz (no bias) and
    hn (bias), orthogonal. forward(h, x) → h', where
    r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r·hn(h)) and h' = (1 - z)·n + z·h (torch.nn.GRUCell's
    function with its hidden-side r and z biases held at 0)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for g in ("r", "z", "n"):
            self.add_module(f"i{g}", Dense(in_dim, dim, generator=generator))
        for g in ("r", "z", "n"):
            lin = Dense(dim, dim, use_bias=g == "n", generator=generator)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
            self.add_module(f"h{g}", lin)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class PReLU(nn.Module):
    """flax.linen.PReLU: x where x >= 0, else negative_slope·x, one
    learned scalar slope starting at 0.01 (torch.nn.PReLU starts at
    0.25)."""

    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(
            torch.tensor(float(negative_slope)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class LSTMLayer(nn.Module):
    """An LSTM over [B, L, D] returning every step's hidden state [B, L,
    dim], from a zero carry (counterpart of
    euler_tpu/utils/layers.py:LSTMLayer, nn.RNN(OptimizedLSTMCell)). The
    cell's scope is flax's, "OptimizedLSTMCell_0"."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_module("OptimizedLSTMCell_0",
                        OptimizedLSTMCell(in_dim, dim, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cell = getattr(self, "OptimizedLSTMCell_0")
        zero = x.new_zeros((x.shape[0], cell.dim), dtype=torch.float32)
        carry, outs = (zero, zero), []
        for t in range(x.shape[1]):
            carry, y = cell(carry, x[:, t])
            outs.append(y)
        return torch.stack(outs, dim=1)
