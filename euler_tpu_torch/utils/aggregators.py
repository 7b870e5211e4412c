"""Dense neighborhood aggregators (counterpart of
euler_tpu/utils/aggregators.py): Mean, MeanPool, MaxPool, GCN.

Each takes x [B, D] and the sampled neighbors nbr [B, K, D]. The Mean
aggregator also takes the neighbor mean precomputed (`nbr_mean` [B, D],
e.g. from ops.gather_mean), so the [B, K, D] layer need not exist.
Submodule names ("self", "nbr", "mlp", "w") are flax's, so a converted
flax param tree loads by name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.utils.layers import Dense

__all__ = ["MeanAggregator", "MeanPoolAggregator", "MaxPoolAggregator",
           "GCNAggregator", "get_aggregator"]


def _activation(name: Optional[str]):
    if not name:
        return lambda v: v
    return getattr(torch, name)


class MeanAggregator(nn.Module):
    """concat(act(W_self x), act(W_nbr mean_k(nbr))) → [B, 2*dim]
    (or the sum if concat=False)."""

    def __init__(self, in_dim: int, dim: int, activation: str = "relu",
                 concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.concat = concat
        self.self = Dense(in_dim, dim, generator=generator)
        self.nbr = Dense(in_dim, dim, generator=generator)
        self.out_dim = 2 * dim if concat else dim

    def forward(self, x: torch.Tensor, nbr: Optional[torch.Tensor] = None,
                nbr_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (nbr is None) == (nbr_mean is None):
            raise ValueError("pass exactly one of nbr and nbr_mean")
        if nbr_mean is None:
            nbr_mean = nbr.mean(1)
        h_self = self.act(self.self(x))
        h_nbr = self.act(self.nbr(nbr_mean))
        if self.concat:
            return torch.cat([h_self, h_nbr], dim=-1)
        return h_self + h_nbr


class _PoolAggregator(nn.Module):
    """MLP per neighbor, pooled over K, then a transform; concat with the
    self transform."""

    def __init__(self, in_dim: int, dim: int, activation: str = "relu",
                 concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.concat = concat
        self.self = Dense(in_dim, dim, generator=generator)
        self.mlp = Dense(in_dim, dim, generator=generator)
        self.nbr = Dense(dim, dim, generator=generator)
        self.out_dim = 2 * dim if concat else dim

    def pool(self, h: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        h_self = self.act(self.self(x))
        h_nbr = self.act(self.nbr(self.pool(self.act(self.mlp(nbr)))))
        if self.concat:
            return torch.cat([h_self, h_nbr], dim=-1)
        return h_self + h_nbr


class MeanPoolAggregator(_PoolAggregator):
    def pool(self, h):
        return h.mean(1)


class MaxPoolAggregator(_PoolAggregator):
    def pool(self, h):
        return h.amax(1)


class GCNAggregator(nn.Module):
    """act(W · mean(concat(x, nbr))) — one shared transform."""

    def __init__(self, in_dim: int, dim: int, activation: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _activation(activation)
        self.w = Dense(in_dim, dim, generator=generator)
        self.out_dim = dim

    def forward(self, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        both = torch.cat([x[:, None, :], nbr], dim=1)
        return self.act(self.w(both.mean(1)))


_AGGREGATORS = {
    "mean": MeanAggregator,
    "meanpool": MeanPoolAggregator,
    "maxpool": MaxPoolAggregator,
    "gcn": GCNAggregator,
}


def get_aggregator(name: str):
    try:
        return _AGGREGATORS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; options: {sorted(_AGGREGATORS)}"
        ) from None
