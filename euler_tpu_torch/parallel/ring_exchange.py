"""Ring and all-gather embedding exchanges over the mesh's 'model'
axis (counterpart of euler_tpu/parallel/ring_exchange.py:33-172).

Each rank of a model group holds rows [r·R/K, (r+1)·R/K) of a table
and a block of lookup ids; both lookups return the block's rows, the
same bytes as a plain take on the whole table (one owner per id, so the
sum has one nonzero term: exact for float and int8).

- ring_lookup: K steps; at each, a rank answers the visiting ids that
  fall in its rows and passes (ids, partial answers) on to the next
  rank (one batch_isend_irecv, the reference's ppermute). Peak traffic
  a step is 1/K of the all-gather's.
- allgather_lookup: all-gather the id blocks, answer every id the rank
  owns, reduce-scatter the answers (two collectives, the full [B, D]
  answer buffer on every rank).

Both are autograd Functions, each backward the transpose of its
collective: the gradient blocks travel the reverse ring, or are
all-gathered in place of the reduce-scatter, and each rank adds the
rows it owns into its shard's gradient.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.parallel import collectives


def _local_answer(table_shard: torch.Tensor, ids: torch.Tensor,
                  shard_lo: int) -> torch.Tensor:
    """Rows for ids inside this shard's range, zeros (of the table's
    dtype: int8 stays int8) elsewhere."""
    local = ids.long() - shard_lo
    ok = (local >= 0) & (local < table_shard.shape[0])
    rows = table_shard[local.clamp(0, table_shard.shape[0] - 1)]
    return rows.masked_fill(~ok[:, None], 0)


def _add_owned(grad: torch.Tensor, ids: torch.Tensor, g: torch.Tensor,
               shard_lo: int) -> None:
    """grad[ids - lo] += g for the ids this shard owns (the others add
    zeros to a clamped row: no data-dependent shapes)."""
    local = ids.long() - shard_lo
    ok = (local >= 0) & (local < grad.shape[0])
    grad.index_add_(0, local.clamp(0, grad.shape[0] - 1),
                    g * ok[:, None].to(g.dtype))


class _RingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, group, k, me):
        lo = me * table.shape[0]
        ctx.save_for_backward(ids)
        ctx.group, ctx.k, ctx.lo, ctx.shape = group, k, lo, table.shape
        cur = ids
        acc = table.new_zeros((ids.shape[0], table.shape[1]))
        for _ in range(k):
            acc = acc + _local_answer(table, cur, lo)
            cur, acc = collectives.ring_shift([cur, acc], group)
        # after K hops every block (and its answers) is home again
        return acc

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        grad = g.new_zeros(ctx.shape)
        cur, cg = ids, g.contiguous()
        for step in range(ctx.k):
            _add_owned(grad, cur, cg, ctx.lo)
            if step + 1 < ctx.k:
                cur, cg = collectives.ring_shift([cur, cg], ctx.group, -1)
        return grad, None, None, None, None


class _AllGatherLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, group, me):
        lo = me * table.shape[0]
        all_ids = collectives.all_gather(ids, group)              # [B]
        ctx.save_for_backward(all_ids)
        ctx.group, ctx.lo, ctx.shape = group, lo, table.shape
        ans = _local_answer(table, all_ids, lo)                   # [B, D]
        # one owner per id: the scatter-sum reassembles exact rows
        return collectives.reduce_scatter(ans, group)

    @staticmethod
    def backward(ctx, g):
        all_ids, = ctx.saved_tensors
        all_g = collectives.all_gather(g.contiguous(), ctx.group)
        grad = g.new_zeros(ctx.shape)
        _add_owned(grad, all_ids, all_g, ctx.lo)
        return grad, None, None, None


def ring_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                axis: str = "model") -> torch.Tensor:
    """table: this rank's [R/K, D] row shard over `axis`; ids: its block
    of [B/K] int ids in [0, R). Returns the block's [B/K, D] rows."""
    return _RingLookup.apply(table, ids, mesh.group(axis), mesh.size(axis),
                             mesh.index(axis))


def allgather_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                     axis: str = "model") -> torch.Tensor:
    """ring_lookup's one-collective alternative: the same calling
    convention and the same bytes."""
    return _AllGatherLookup.apply(table, ids, mesh.group(axis),
                                  mesh.index(axis))


# Per-rank byte budget below which the all-gather variant's full [B, D]
# answer buffer is taken to be cheap (the reference's value, tuned for
# its chips; the port has not measured its own).
ALLGATHER_MAX_BYTES = 64 << 20


def pick_lookup_strategy(n_ids: int, k: int, dim: int,
                         elem_bytes: int = 4,
                         allgather_max_bytes: int = ALLGATHER_MAX_BYTES
                         ) -> str:
    """Per-step lookup-strategy pick on ids shipped × K (copy of the
    reference's): K <= 1 → 'local' (a plain take); n_ids·K·D·elem within
    the budget → 'allgather' (2 collectives); else 'ring' (1/K of the
    peak footprint)."""
    if k <= 1:
        return "local"
    if n_ids * k * dim * elem_bytes <= allgather_max_bytes:
        return "allgather"
    return "ring"


def reference_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The one-device equivalent, a plain take: the bytes ring_lookup and
    allgather_lookup must reproduce."""
    return table[ids.long()]
