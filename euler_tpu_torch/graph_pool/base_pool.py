"""Graph-level readout pools (counterpart of
euler_tpu/graph_pool/base_pool.py:19-70): node embeddings x [N, D] and
graph_index [N], each node's graph, to one row per graph
[num_graphs, ...]. num_graphs is a Python int, as the reference's is
static. A node whose graph id is outside [0, num_graphs) is left out,
as mp_ops drops it."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense, OptimizedLSTMCell


class SumPool(nn.Module):
    def forward(self, x: torch.Tensor, graph_index: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        return mp.scatter_add(x, graph_index, num_graphs)


class MeanPool(nn.Module):
    def forward(self, x: torch.Tensor, graph_index: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        return mp.scatter_mean(x, graph_index, num_graphs)


class MaxPool(nn.Module):
    def forward(self, x: torch.Tensor, graph_index: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        return mp.scatter_max(x, graph_index, num_graphs)


class AttentionPool(nn.Module):
    """Gated attention readout: Σ softmax(gate(x)) · proj(x) over each
    graph's nodes (Dense "gate" to one logit, Dense "proj" to dim)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = int(dim)
        self.gate = Dense(in_dim, 1, generator=generator)
        self.proj = Dense(in_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, graph_index: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        att = mp.scatter_softmax(self.gate(x)[:, 0], graph_index, num_graphs)
        return mp.scatter_add(self.proj(x) * att[:, None], graph_index,
                              num_graphs)


class Set2SetPool(nn.Module):
    """Set2Set readout [num_graphs, 2·dim]: processing_steps rounds of an
    LSTM (flax's OptimizedLSTMCell, "OptimizedLSTMCell_0", from a zero
    carry) reading q* = [q, r], each attending over its graph's
    projected nodes (Dense "proj") with the query q."""

    def __init__(self, in_dim: int, dim: int, processing_steps: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = int(dim)
        self.out_dim = 2 * self.dim
        self.processing_steps = int(processing_steps)
        self.add_module("OptimizedLSTMCell_0", OptimizedLSTMCell(
            2 * self.dim, self.dim, generator=generator))
        self.proj = Dense(in_dim, dim, generator=generator)

    def forward(self, x: torch.Tensor, graph_index: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        cell = getattr(self, "OptimizedLSTMCell_0")
        h = self.proj(x)                                      # [N, dim]
        zero = h.new_zeros((num_graphs, self.dim))
        carry = (zero, zero)
        q_star = h.new_zeros((num_graphs, 2 * self.dim))
        for _ in range(self.processing_steps):
            carry, q = cell(carry, q_star)                    # [G, dim]
            e = (h * mp.gather(q, graph_index)).sum(-1)       # [N]
            a = mp.scatter_softmax(e, graph_index, num_graphs)
            r = mp.scatter_add(h * a[:, None], graph_index, num_graphs)
            q_star = torch.cat([q, r], dim=-1)
        return q_star
