"""GraphSAGE fanout encoder (counterpart of
euler_tpu/utils/encoders.py:58-102, `_hop_neighbors` and `SageEncoder`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch.utils.aggregators import get_aggregator


def _hop_neighbors(child: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Reshape hop h+1's flat layer to [n_h, k, D], deriving k from the
    shapes."""
    n = parent.shape[0]
    if child.shape[0] % n != 0:
        raise ValueError(f"layer of {child.shape[0]} rows is not a whole "
                         f"fanout of the {n}-row parent layer")
    return child.reshape(n, child.shape[0] // n, -1)


class SageEncoder(nn.Module):
    """GraphSAGE encoder over a sampled fanout.

    layers[h]: features of hop h, [B·Πk_{<h}, D]. Aggregates deepest
    first with fresh aggregator params per depth (submodules agg_{d}).
    The deepest hop L may be passed either as its gathered rows
    (layers has L+1 entries) or, with the 'mean' aggregator, as its
    neighbor mean `nbr_mean` [B·Πk_{<L}, D] (layers has L entries): at
    depth 0 hop L-1 reads hop L only through that mean, so the [n·k, D]
    deepest layer never has to exist.
    """

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 aggregator: str = "mean", concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanouts = tuple(int(k) for k in fanouts)
        self.aggregator = aggregator.lower()
        agg_cls = get_aggregator(aggregator)
        width = in_dim
        for depth in range(len(self.fanouts)):
            agg = agg_cls(width, dim, concat=concat, generator=generator)
            self.add_module(f"agg_{depth}", agg)
            width = agg.out_dim
        self.out_dim = width

    def forward(self, layers: Sequence[torch.Tensor],
                nbr_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_hops = len(self.fanouts)
        if nbr_mean is not None and self.aggregator != "mean":
            raise ValueError("a precomputed neighbor mean needs the 'mean' "
                             f"aggregator, not {self.aggregator!r}")
        want = n_hops if nbr_mean is not None else n_hops + 1
        if len(layers) != want:
            raise ValueError(f"need {want} feature layers for {n_hops} "
                             f"fanouts, got {len(layers)}")
        hidden = list(layers)
        for depth in range(n_hops):
            agg = getattr(self, f"agg_{depth}")
            next_hidden = []
            for hop in range(n_hops - depth):
                x = hidden[hop]
                if nbr_mean is not None and depth == 0 and hop == n_hops - 1:
                    next_hidden.append(agg(x, nbr_mean=nbr_mean))
                else:
                    next_hidden.append(
                        agg(x, _hop_neighbors(hidden[hop + 1], x)))
            hidden = next_hidden
        return hidden[0]
