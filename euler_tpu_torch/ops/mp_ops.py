"""Message-passing primitives (counterpart of euler_tpu/ops/mp_ops.py:
30-87): plain functions on tensors over torch's index ops.

`index` maps each message row to its destination segment (an int32 or
int64 tensor); `num_segments` is a Python int, as the reference's must
be static under jit. The reference's segment ops are XLA's, outside any
Pallas kernel; here they are torch's index ops and `scatter_reduce`.

Every sum repeats bit for bit from run to run. On the CPU a segment sum
is `index_add`, which adds in index order. On CUDA `index_add` (and
`index_select`'s backward, which is one) adds with atomics, in an order
that changes between runs: over hundreds of training steps with dropout
that drift moved a 3-seed test F1 by several points. So on CUDA a sum is
`index_put` with accumulate, which sorts the indices and adds each
segment's rows in that order, and `gather` is an indexing whose backward
is that same sorted sum. The order differs from the CPU's and XLA's, so
the last bits do too.
"""

from __future__ import annotations

import torch

__all__ = [
    "gather",
    "scatter_add",
    "scatter_mean",
    "scatter_max",
    "scatter_softmax",
    "segment_count",
    "degree_norm",
]


def gather(params: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """params[indices], a row gather (the reference's MPGather); its
    gradient is a segment sum over `indices`, the same bits every run."""
    if params.is_cuda:
        return params[indices.long()]
    return params.index_select(0, indices.long())


def scatter_add(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of `src` into `num_segments` buckets (the
    reference's MPScatterAdd, jax.ops.segment_sum), the same bits every
    run."""
    out = src.new_zeros((int(num_segments),) + tuple(src.shape[1:]))
    if src.is_cuda:
        return out.index_put((index.long(),), src, accumulate=True)
    return out.index_add(0, index.long(), src)


def segment_count(index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Rows per segment, float32 [num_segments]."""
    ones = torch.ones(index.shape[0], dtype=torch.float32,
                      device=index.device)
    return scatter_add(ones, index, num_segments)


def scatter_mean(src: torch.Tensor, index: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Segment sums over max(count, 1): an empty segment is 0."""
    total = scatter_add(src, index, num_segments)
    count = segment_count(index, num_segments).clamp_min(1.0)
    return total / (count[:, None] if total.dim() > 1 else count)


def _segment_max(src: torch.Tensor, index: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """jax.ops.segment_max: -inf where a segment is empty."""
    idx = index.long().reshape((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    out = src.new_full((int(num_segments),) + tuple(src.shape[1:]),
                       float("-inf"))
    return out.scatter_reduce(0, idx, src, "amax", include_self=True)


def scatter_max(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max-reduce rows into buckets; an empty bucket gives 0, as the
    reference clamps it (scatter_reduce alone would leave its fill)."""
    out = _segment_max(src, index, num_segments)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def scatter_softmax(logits: torch.Tensor, index: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of the logits [E] or [E, H] within each segment (GAT's
    attention), shifted by the segment's max for stability. The shift
    does not change the softmax, so it is taken without a gradient: the
    way a tie's gradient would split between its maxima cannot show in
    the result's gradient (in exact arithmetic it cancels, as it does
    through the reference's shift)."""
    seg_max = _segment_max(logits.detach(), index, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[index.long()])
    denom = scatter_add(ex, index, num_segments)
    return ex / gather(denom, index).clamp_min(1e-16)


def degree_norm(edge_index: torch.Tensor, num_nodes: int,
                add_self_loops: bool = True) -> torch.Tensor:
    """GCN's symmetric per-edge coefficients 1/sqrt(deg(src) deg(dst)),
    deg counted over destinations (+1 with self-loops). edge_index [2,
    E] (src, dst)."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    deg = segment_count(dst, num_nodes)
    if add_self_loops:
        deg = deg + 1.0
    dinv = torch.rsqrt(deg.clamp_min(1.0))
    return dinv[src] * dinv[dst]
