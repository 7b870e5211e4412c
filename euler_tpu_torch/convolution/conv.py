"""Base machinery of the message-passing convolutions (counterpart of
euler_tpu/convolution/conv.py:26-64): `split_x`, `aggregate`, `Conv`,
and `sym_norm`, the normalization the shared-node-set convolutions
compute alike.

Conventions, as the reference's:
  x           [N, D] node features, or (x_src, x_tgt) for a bipartite
              block; a single tensor is a shared node set (the
              reference's `x_src is x_tgt`)
  edge_index  [2, E] int32; row 0 the message source, row 1 its
              destination
  num_nodes   the destination count (default x_tgt's rows)

Each module takes its input width (`in_dim`), which flax infers at
init, and records its output width as `out_dim`. Parameters keep the
reference's names (Dense `lin`, `att_src`, `beta`, ...), so
euler_tpu_torch.convert maps the two trees.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense

XInput = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def split_x(x: XInput) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_src, x_tgt); a single tensor serves as both."""
    if isinstance(x, tuple):
        return x
    return x, x


def aggregate(msgs: torch.Tensor, dst: torch.Tensor, num_nodes: int,
              aggr: str) -> torch.Tensor:
    if aggr in ("add", "sum"):
        return mp.scatter_add(msgs, dst, num_nodes)
    if aggr == "mean":
        return mp.scatter_mean(msgs, dst, num_nodes)
    if aggr == "max":
        return mp.scatter_max(msgs, dst, num_nodes)
    raise ValueError(f"unknown aggregation: {aggr}")


def sym_norm(edge_index: torch.Tensor, n: int):
    """(norm [E], self_norm [n]) over a shared node set: each edge's
    1/sqrt(d̂_src d̂_dst) and each node's self-loop 1/d̂, with d̂ the
    degree + 1 (src degrees over sources, dst over destinations)."""
    src, dst = edge_index[0], edge_index[1]
    deg = mp.segment_count(dst, n) + 1.0
    deg_s = mp.segment_count(src, n) + 1.0
    norm = torch.rsqrt(deg_s)[src.long()] * torch.rsqrt(deg)[dst.long()]
    return norm, 1.0 / deg


def propagate(z: torch.Tensor, edge_index: torch.Tensor, n: int,
              norm: torch.Tensor) -> torch.Tensor:
    """Σ_j norm_ij z_j over the incoming edges of each of n nodes."""
    return mp.scatter_add(mp.gather(z, edge_index[0]) * norm[:, None],
                          edge_index[1], n)


def shared_only(x: XInput, what: str) -> torch.Tensor:
    """x as one tensor; a bipartite tuple raises, as the reference's
    convolutions that need a shared node set do."""
    x_src, x_tgt = split_x(x)
    if x_src is not x_tgt:
        raise ValueError(f"{what} requires a shared node set")
    return x_src


class Conv(nn.Module):
    """Generic message-passing layer: linear → gather → aggregate."""

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "add",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        self.out_dim = int(out_dim)
        self.lin = Dense(in_dim, out_dim, generator=generator)

    def forward(self, x: XInput, edge_index: torch.Tensor,
                num_nodes: Optional[int] = None) -> torch.Tensor:
        x_src, x_tgt = split_x(x)
        n = num_nodes if num_nodes is not None else x_tgt.shape[0]
        msgs = mp.gather(self.lin(x_src), edge_index[0])
        return aggregate(msgs, edge_index[1], n, self.aggr)
