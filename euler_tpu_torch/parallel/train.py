"""The SPMD training step over a ('data', 'model') mesh (counterpart of
euler_tpu/parallel/train.py:27-133).

A model takes the data axis one of two ways; `splits_over_data`
decides, and the estimator's batches, steps, evaluate() and run_eval
all read it:

- split (a model class with `splits_over_data = True`): every rank
  runs the step on its data slice of the batch (mesh.shard_batch),
  the forward inside collectives.data_parallel (draws sliced from the
  global batch's; the loss and the metric this rank's share of the
  global batch's: utils.metrics.masked_mean and micro_f1 divide by the
  all-reduced count), then one SUM of all parameter gradients over
  'data' (a row-sharded shard's and a replicated parameter's alike);
- replicated (every other model): every data rank takes the whole
  batch and computes the same loss and gradient, and nothing is summed
  over 'data'. This is the reference's semantics: its estimator never
  splits a batch over 'data' (euler_tpu/estimator/base_estimator.py:
  305-310 stores a data sharding that nothing reads).

Either way the nonfinite guard is decided for every rank by an
all-reduced flag, and replicated parameters and their optimizer state
stay equal bit for bit across ranks.

The estimator (BaseEstimator(mesh=...)) runs the same `spmd_update`;
make_spmd_train_step serves callers that hold their own state.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.obs.device import mark
from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.sharded_embedding import apply_param_shardings
from euler_tpu_torch.ops.row_sparse_adam import densify

__all__ = ["spmd_init", "make_spmd_train_step", "spmd_update",
           "reduce_gradients", "splits_over_data", "data_mesh",
           "global_values"]


def reduce_gradients(params: Iterable[torch.nn.Parameter], mesh) -> None:
    """SUM every parameter's gradient over the mesh's data group, as one
    collective over one flat buffer (a no-op without a mesh). A
    row-sparse gradient (utils/layers.Embedding on CUDA) is made dense
    first (ops/row_sparse_adam.densify) on a data axis of 2 or more: the
    same traffic as a dense table gradient; on a data axis of 1 it is
    left out of the sum (over one rank, the gradient itself) and stays
    sparse."""
    if mesh is None:
        return
    params = [p for p in params if p.grad is not None]
    if mesh.size("data") > 1:
        for p in params:
            p.grad = densify(p.grad)
    grads = [p.grad for p in params if not p.grad.is_sparse]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collectives.all_reduce(flat, mesh.group("data"))
    torch._foreach_copy_(grads, [
        t.view_as(g) for t, g in zip(flat.split([g.numel() for g in grads]),
                                     grads)])


def splits_over_data(model: torch.nn.Module, mesh) -> bool:
    """Whether each data rank takes its slice of a batch for `model` on
    `mesh`: a model class sets `splits_over_data` when every per-step
    batch array is row-aligned with the roots (a rank's slice is its
    roots' rows) and its loss and metric are utils.metrics.masked_mean,
    mrr or micro_f1, which inside collectives.data_parallel give this
    rank's share of the global batch's value. Every such class is held
    to its one-process run on 4 gloo ranks. False without a mesh."""
    return mesh is not None and bool(getattr(model, "splits_over_data",
                                             False))


def data_mesh(model: torch.nn.Module, mesh):
    """The mesh whose data axis `model`'s batches split over (for
    mesh.data_slice, collectives.data_parallel and global_values), None
    for a replicated model or without a mesh."""
    return mesh if splits_over_data(model, mesh) else None


def global_values(values: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's loss and metric (no gradient) from this rank's
    shares of them: one SUM over 'data'. The values themselves on a
    data axis of size 1 or without a mesh (a replicated model's values
    are already the global batch's: pass data_mesh(model, mesh))."""
    if mesh is None or mesh.size("data") <= 1:
        return values.detach()
    return collectives.all_reduce(values.detach().clone(),
                                  mesh.group("data"))


def spmd_update(model: torch.nn.Module, optimizer, batch: Dict[str, Any],
                mesh, nonfinite_guard: bool = True,
                one: Optional[torch.Tensor] = None):
    """Forward, backward, the gradient SUM over 'data' (a split model's
    only), the guard and the optimizer step on this rank's batch: its
    slice for a split model, the whole batch for a replicated one
    (splits_over_data). Returns (the global batch's loss, its metric,
    found_inf: a [] float tensor, 1.0 on a skipped step; None without
    the guard). Nothing waits for the device, so a CUDA graph can
    capture it (NCCL's collectives included). The phase marks of
    obs/device.py close `forward`, `backward` and `optimizer` in the
    update a caller's PhaseRecorder has open (none: no-ops)."""
    dmesh = data_mesh(model, mesh)
    with collectives.data_parallel(dmesh):
        out = model(batch)
    mark("forward")
    optimizer.zero_grad(set_to_none=True)
    out.loss.backward()
    reduce_gradients(model.parameters(), dmesh)
    mark("backward")
    loss, metric = global_values(
        torch.stack([out.loss.detach().float(),
                     out.metric.detach().float()]), dmesh).unbind()
    found_inf = None
    if nonfinite_guard:
        # a row-sparse gradient's rows, each lookup's apart: the rows it
        # leaves out are exact zeros. The optimizer sums an id's rows
        # after the guard, so finite rows whose sum overflows pass here,
        # where the guard on the dense gradient read the sum.
        grads = [p.grad._values() if p.grad.is_sparse else p.grad
                 for p in model.parameters() if p.grad is not None]
        found_inf = (~torch.isfinite(loss)).to(torch.float32)
        if one is None:
            one = torch.ones((), device=loss.device)
        # GradScaler's check: one multi-tensor pass over the grads sets
        # found_inf to 1 on a NaN or Inf (and scales by 1)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found_inf, one)
        if mesh is not None and dist.get_world_size() > 1:
            # one rank's bad step is every rank's: the replicas (and the
            # shards of a model group) must not drift apart
            collectives.all_reduce(found_inf, None, op=dist.ReduceOp.MAX)
        optimizer.found_inf = found_inf
    optimizer.step()
    mark("optimizer")
    return loss, metric, found_inf


def spmd_init(model: torch.nn.Module,
              tx: Callable[[Iterable[torch.nn.Parameter]], Any],
              mesh) -> Dict[str, Any]:
    """The sharded train state: the model (built alike on every rank from
    one explicit torch.Generator) keeps its rank's rows of every
    row-partitioned parameter (apply_param_shardings) on mesh.device,
    and tx(params) builds the optimizer over what is left, its state
    beside each parameter. Returns {"model", "optimizer", "step",
    "skipped_steps"}."""
    apply_param_shardings(model, mesh)
    return {"model": model, "optimizer": tx(model.parameters()),
            "step": 0,
            "skipped_steps": torch.zeros((), dtype=torch.int32,
                                         device=mesh.device)}


def make_spmd_train_step(mesh, nonfinite_guard: bool = True,
                         table_store=None,
                         table_rows_key: str = "rows") -> Callable:
    """(state, batch) → (state, loss, metric): one spmd_update of
    state["model"] on this rank's batch (its slice for a split model). A guarded bad step keeps
    the parameters and the optimizer state and bumps
    state["skipped_steps"]. table_store (a PartitionedFeatureStore)
    counts each step's table rows (batch[table_rows_key], a host row
    array or a list of them) with observe_batch before the step.
    Counted on the obs registry: spmd_steps_total, spmd_dispatch_ms."""
    reg = _obs.default_registry()
    c_steps = reg.counter("spmd_steps_total", "SPMD train-step dispatches")
    h_dispatch = reg.histogram(
        "spmd_dispatch_ms",
        "host-side SPMD train-step dispatch latency (excludes device "
        "time the host did not wait for)")
    one = torch.ones((), device=mesh.device)

    def stepped(state, batch):
        t0 = time.monotonic()
        if table_store is not None and table_rows_key in batch:
            rows = batch[table_rows_key]
            for r in (rows if isinstance(rows, (list, tuple)) else [rows]):
                table_store.observe_batch(
                    r.cpu().numpy() if isinstance(r, torch.Tensor)
                    else np.asarray(r))
        model = state["model"]
        with _obs.span("spmd_train_step"):
            model.train()
            loss, metric, found_inf = spmd_update(
                model, state["optimizer"], batch, mesh, nonfinite_guard,
                one)
        state = dict(state)
        state["step"] = state["step"] + 1
        if found_inf is not None:
            state["skipped_steps"] = state["skipped_steps"] \
                + found_inf.to(torch.int32)
        c_steps.inc()
        h_dispatch.observe((time.monotonic() - t0) * 1000.0)
        return state, loss, metric

    return stepped
