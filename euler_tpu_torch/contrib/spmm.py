"""Sparse(adjacency) × dense product as a segment sum (counterpart of
euler_tpu/contrib/spmm.py): out[dst] += w · x[src] over an edge list,
built on mp_ops' sums, so it repeats bit for bit on the card."""

from __future__ import annotations

from typing import Optional

import torch

from euler_tpu_torch.ops import mp_ops as mp


def _indexed_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """jnp's `x[index]`: a negative index wraps once, then the index is
    clamped into [0, n) for the value, while the gradient of a row read
    through an index outside [-n, n) is dropped, as XLA's scatter drops
    it in the gather's transpose."""
    n = x.shape[0]
    idx = index.long()
    rows = mp.gather(x, torch.where(idx < 0, idx + n, idx).clamp(0, n - 1))
    outside = ((idx >= n) | (idx < -n))[:, None]
    return torch.where(outside, rows.detach(), rows)


def spmm(edge_index: torch.Tensor, x: torch.Tensor, num_rows: int,
         edge_weight: Optional[torch.Tensor] = None,
         normalize: bool = False) -> torch.Tensor:
    """out [num_rows, D] with out[dst] += w · x[src] for each edge.

    edge_index: [2, E] (src, dst) rows, as mp_ops and the convolutions
    take it; x: [N, D]; edge_weight: [E] or None (1 each). A destination
    outside [0, num_rows) is dropped, as jax.ops.segment_sum drops it.
    normalize divides each output row by its incoming weight sum, at
    least 1e-12 (a mean)."""
    src, dst = edge_index[0], edge_index[1]
    msgs = _indexed_rows(x, src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None].to(msgs.dtype)
    out = mp.scatter_add(msgs, dst, num_rows)
    if normalize:
        ones = (torch.ones(dst.shape[0], dtype=msgs.dtype,
                           device=msgs.device)
                if edge_weight is None else edge_weight.to(msgs.dtype))
        deg = mp.scatter_add(ones, dst, num_rows)
        out = out / torch.clamp(deg, min=1e-12)[:, None]
    return out
