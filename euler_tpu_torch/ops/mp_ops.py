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

Indices outside the table follow the reference's XLA ops. `gather` is
jnp.take's fill mode: an index in [-n, -1] wraps to n + i, any other
outside [0, n) gives a NaN row (the integer type's minimum for an
integer table). The segment ops drop a segment id outside [0, n), as
jax.ops.segment_sum and segment_max do: such rows go to one sink row
past the n segments, which is cut off, so no shape depends on the
data and nothing waits for the host.
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
    """params[indices], a row gather (the reference's MPGather, jnp.take
    in fill mode); its gradient is a segment sum over `indices`, the
    same bits every run, and 0 for a filled row."""
    n = params.shape[0]
    idx = indices.long()
    bad = (idx >= n) | (idx < -n)
    idx = idx.masked_fill(bad, 0)
    if params.is_cuda:
        out = params[idx]  # indexing wraps [-n, -1]
    else:
        out = params.index_select(0, torch.where(idx < 0, idx + n, idx))
    fill = (float("nan") if params.dtype.is_floating_point
            else torch.iinfo(params.dtype).min)
    return out.masked_fill(bad.view(*bad.shape, *[1] * (params.dim() - 1)),
                           fill)


def _sink(index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The segment ids as int64, any outside [0, num_segments) moved to
    the sink segment num_segments."""
    idx = index.long()
    return idx.masked_fill((idx < 0) | (idx >= num_segments), num_segments)


def _sum(src: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """Sums of `src`'s rows into `rows` buckets by in-range ids."""
    out = src.new_zeros((rows,) + tuple(src.shape[1:]))
    if src.is_cuda:
        return out.index_put((idx,), src, accumulate=True)
    return out.index_add(0, idx, src)


def scatter_add(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of `src` into `num_segments` buckets (the
    reference's MPScatterAdd, jax.ops.segment_sum), the same bits every
    run; a row whose id is outside [0, num_segments) is dropped."""
    n = int(num_segments)
    return _sum(src, _sink(index, n), n + 1)[:n]


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


def _segment_max(src: torch.Tensor, idx: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """jax.ops.segment_max over `rows` buckets by in-range ids: -inf
    where a bucket is empty."""
    idx = idx.reshape((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    out = src.new_full((rows,) + tuple(src.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx, src, "amax", include_self=True)


def scatter_max(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max-reduce rows into buckets; an empty bucket gives 0, as the
    reference clamps it (scatter_reduce alone would leave its fill); a
    row whose id is outside [0, num_segments) is dropped."""
    n = int(num_segments)
    out = _segment_max(src, _sink(index, n), n + 1)[:n]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def scatter_softmax(logits: torch.Tensor, index: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of the logits [E] or [E, H] within each segment (GAT's
    attention), shifted by the segment's max for stability. The shift
    does not change the softmax, so it is taken without a gradient: the
    way a tie's gradient would split between its maxima cannot show in
    the result's gradient (in exact arithmetic it cancels, as it does
    through the reference's shift). Entries whose id is outside [0,
    num_segments) share the sink segment: their values mean nothing
    (the reference's are meaningless there too), and they leave the
    other segments alone."""
    n = int(num_segments)
    idx = _sink(index, n)
    seg_max = _segment_max(logits.detach(), idx, n + 1)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[idx])
    denom = _sum(ex, idx, n + 1)
    return ex / gather(denom, idx).clamp_min(1e-16)


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
