"""The collectives of the ('data', 'model') mesh, with the gradients
the port's one-process-per-device SPMD needs.

The reference is single-controller SPMD: one program sees the global
batch and GSPMD inserts the collectives. Here every device is a process
holding its data slice of the batch (the same slice on every rank of a
model group) and, for a row-sharded table, its rows. What that changes:

- A row-sharded read is a masked local take and one SUM over 'model'
  (`model_sum`). Every rank of the model group computes the same loss
  from the summed rows, so the upstream gradient is already the whole
  gradient on each of them: the backward is the identity. Summing it
  again (torch.distributed.nn.functional.all_reduce's backward) would
  make a shard's gradient mp times too large.
- `gather_replicated` all-gathers blocks over 'model' for consumers
  that are replicated across the group (its backward keeps the own
  block); `gather_summed` all-gathers over 'data', where each rank's
  loss is its own (its backward reduce-scatters the sum).
- The loss is a mean over the global batch: inside `data_parallel(mesh)`
  (a data axis of size > 1) utils.metrics.masked_mean divides the local
  masked sum by the all-reduced count (micro_f1 its 2·tp by the global
  denominator), so each rank's loss and metric are its shares of the
  global batch's; the step sums them, and the parameter gradients,
  over 'data'. Only a model whose batch splits over the data axis runs
  inside it (parallel.train.splits_over_data); any other model takes
  the whole batch on every data rank, outside it.
- A draw over batch rows is made for the global batch and sliced
  (`draw_rows`): every rank of a data axis draws from the same generator,
  so a sharded run picks what the one-process run picks.

`counts` records the collectives each host call issues (a CUDA graph's
replay issues its recorded ones without calling here).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# host calls that issued a collective, by kind
counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                          "reduce_scatter": 0, "send_recv": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def total_count() -> int:
    return sum(counts.values())


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of t over `group`; returns t."""
    counts["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each of the group's r ranks → [r·n, ...] in rank
    order."""
    size = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    counts["all_gather"] += 1
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """[r·n, ...] summed over the group's r ranks, rank i keeping rows
    [i·n, (i+1)·n)."""
    size = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
    counts["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group,
               step: int = 1) -> List[torch.Tensor]:
    """Each tensor sent `step` ranks on around the group's ring, the
    previous rank's received in its place (one batch_isend_irecv)."""
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + step) % len(ranks)], ranks[(me - step) % len(ranks)]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    counts["send_recv"] += 1
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


class _ModelSum(torch.autograd.Function):
    """Forward: SUM over the group. Backward: the identity (the group's
    consumers are replicated; see the module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _ModelSum.apply(x, group)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_group_rank(ctx.group, dist.get_rank())
        return g[i * ctx.n:(i + 1) * ctx.n], None


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather for replicated consumers: the backward keeps this
    rank's block of the (already whole) upstream gradient."""
    return _GatherReplicated.apply(x, group)


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


def gather_summed(x: torch.Tensor, group) -> torch.Tensor:
    """all_gather for per-rank consumers (each rank's loss its own): the
    backward reduce-scatters the summed gradient."""
    return _GatherSummed.apply(x, group)


# -- the data axis inside a step -------------------------------------------


@dataclass(frozen=True)
class DataShard:
    """This rank's place on a data axis of size > 1."""
    size: int
    index: int
    group: object


_DATA: contextvars.ContextVar = contextvars.ContextVar(
    "euler_tpu_torch_data_shard", default=None)


def data_shard() -> Optional[DataShard]:
    """The data axis of the step being run, None outside
    data_parallel or on a data axis of size 1."""
    return _DATA.get()


@contextlib.contextmanager
def data_parallel(mesh):
    """Run a step as this rank's slice of a global batch (see the
    module docstring); nothing changes on a data axis of size 1 or
    without a mesh."""
    if mesh is None or mesh.size("data") <= 1:
        yield None
        return
    tok = _DATA.set(DataShard(mesh.size("data"), mesh.index("data"),
                              mesh.group("data")))
    try:
        yield _DATA.get()
    finally:
        _DATA.reset(tok)


def draw_rows(shape, generator: torch.Generator, device,
              batch_dim: Optional[int] = 0) -> torch.Tensor:
    """float32 uniforms of `shape` from `generator`. Inside
    data_parallel, with batch_dim set, the draw is the global batch's
    (shape[batch_dim] times the data axis) and this rank keeps its
    slice, so every rank picks what one process would."""
    shard = data_shard()
    if shard is None or batch_dim is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    shape = list(shape)
    n = shape[batch_dim]
    shape[batch_dim] = n * shard.size
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.narrow(batch_dim, shard.index * n, n)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the data axis of the step."""
    shard = data_shard()
    if shard is None:
        return count
    return all_reduce(count.detach().clone(), shard.group)


def global_rows(x: torch.Tensor) -> torch.Tensor:
    """The data axis's rows of x in rank order (no gradient): x itself
    outside data_parallel."""
    shard = data_shard()
    if shard is None:
        return x
    return all_gather(x.detach(), shard.group)


def global_rows_summed(x: torch.Tensor) -> torch.Tensor:
    """As global_rows, differentiable: each rank's block gets the
    gradient every rank's loss sends it."""
    shard = data_shard()
    if shard is None:
        return x
    return gather_summed(x, shard.group)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a tensor that holds the data axis's
    rows in rank order: x itself outside data_parallel."""
    shard = data_shard()
    if shard is None:
        return x
    n = x.shape[0] // shard.size
    return x[shard.index * n:(shard.index + 1) * n]
