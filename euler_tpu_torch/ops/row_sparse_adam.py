"""Dense Adam (or AdamW) over a whole float32 table from a row-sparse
gradient.

    grad: sparse COO [N, D], indices [1, nnz] (an id may repeat, in any
          order), values [nnz, D] float32: the rows an Embedding lookup
          read and their gradient rows (utils/layers.Embedding on CUDA)

Every row of the table takes torch's fused Adam step, with g = the sum
of the values of its id (0 where no id touched it):

    AdamW: p -= lr·wd·p              Adam: g += p·wd   (when wd != 0)
    m = fma(b1, m, fma(-b1, g, g))
    v = fma(b2, v, fma(-b2, g·g, g·g))
    step_size = lr / (1 - b1^t),  denom = sqrt(v) / sqrt(1 - b2^t) + eps
    p -= step_size · m / denom

in float32, in the order and with the fma's of ATen's fused kernel
(fused_adam_utils.cuh, adam_math), with t = step + 1. So a row no id
touched decays its moments and still moves, as under torch's Adam on the
dense gradient: this is dense Adam, not torch's SparseAdam (which steps
the touched rows only). `step` (a float32 scalar on the table's device)
ends as t - found_inf; when found_inf (a float32 scalar on the device,
the GradScaler protocol's flag) is 1, the table, m, v and the step stay
exactly as they were. Nothing is read on the host, so a CUDA graph can
capture the step.

Duplicate ids are summed without atomics, in the order they were looked
up: the ids are sorted stably and each run of equal ids summed in that
order, so the same inputs give the same bits on every run.

On a CUDA table `row_sparse_adam` sorts the ids (torch.sort) and
launches the hand-written kernel (csrc/row_sparse_adam.cu): a memset of
an int32 row map [N] (per-step scratch, not optimizer state), a kernel
that maps each id's run and advances the step, and one pass over every
row that reads p, m and v once and writes them once: 24·N·D bytes, and
no [N, D] gradient. On a CPU table it runs the plain PyTorch version,
`row_sparse_adam_reference`. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from euler_tpu_torch.kernels import _build

_MAX_NNZ = 2 ** 31 - 1  # the row map holds int32 positions


def _check(param: torch.Tensor, grad: torch.Tensor, exp_avg: torch.Tensor,
           exp_avg_sq: torch.Tensor, step: torch.Tensor,
           found_inf: Optional[torch.Tensor]) -> None:
    if param.dim() != 2 or param.dtype != torch.float32:
        raise ValueError(f"the table must be float32 [N, D], got "
                         f"{param.dtype} {tuple(param.shape)}")
    if not (grad.is_sparse and grad.sparse_dim() == 1
            and grad.dense_dim() == 1):
        raise ValueError("the gradient must be a sparse COO tensor of rows "
                         "(sparse_dim 1, dense_dim 1)")
    if grad.shape != param.shape or grad.dtype != param.dtype:
        raise ValueError(f"gradient {grad.dtype} {tuple(grad.shape)} does "
                         f"not match the table {param.dtype} "
                         f"{tuple(param.shape)}")
    for name, t in (("exp_avg", exp_avg), ("exp_avg_sq", exp_avg_sq)):
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"{name} must be float32 "
                             f"{tuple(param.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("step", step), ("found_inf", found_inf)):
        if t is not None and (t.dim() != 0 or t.dtype != torch.float32):
            raise ValueError(f"{name} must be a float32 scalar tensor")
    tensors = [param, grad, exp_avg, exp_avg_sq, step] + (
        [found_inf] if found_inf is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the table, its gradient, its state and found_inf "
                         "must be on one device")
    if not all(t.is_contiguous() for t in (param, exp_avg, exp_avg_sq)):
        raise ValueError("the table and its moments must be contiguous")


def densify(grad: torch.Tensor) -> torch.Tensor:
    """A sparse COO gradient as the dense tensor it stands for, a dense
    gradient as it is. Duplicate ids are summed without atomics, so the
    same gradient gives the same bits every run: on CUDA by index_put_
    with accumulate (it sorts the ids), on the CPU by index_add_ (one id
    after another; the CPU's index_put_ with accumulate splits the ids
    over threads, and its sums change from run to run)."""
    if not grad.is_sparse:
        return grad
    ids, values = grad._indices()[0], grad._values()
    dense = torch.zeros(grad.shape, dtype=grad.dtype, device=grad.device)
    if grad.is_cuda:
        return dense.index_put_((ids,), values, accumulate=True)
    return dense.index_add_(0, ids, values)


def _lookup_order_sum(grad: torch.Tensor) -> torch.Tensor:
    """The dense gradient with each id's rows added in the order they
    were looked up, the kernel's order, on any device: the i-th lookup
    of every id goes in by the i-th index_put_, in which no id repeats.
    Reads the longest run on the host."""
    ids, values = grad._indices()[0], grad._values()
    dense = torch.zeros(grad.shape, dtype=grad.dtype, device=grad.device)
    if ids.numel() == 0:
        return dense
    order = torch.sort(ids, stable=True).indices
    run_ids = ids[order]
    pos = torch.arange(ids.numel(), device=ids.device)
    first = torch.ones_like(run_ids, dtype=torch.bool)
    first[1:] = run_ids[1:] != run_ids[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        dense.index_put_((ids[sel],), values[sel], accumulate=True)
    return dense


def _fma(a, b, c) -> torch.Tensor:
    """fma(a, b, c) in float32 through float64: the product of two
    float32 values is exact in float64, then the sum is rounded (to
    float64, then float32: differs from one rounding only on a float64
    tie)."""
    return (a.double() * b.double() + c.double()).float()


@torch.no_grad()
def row_sparse_adam_reference(param: torch.Tensor, grad: torch.Tensor,
                              exp_avg: torch.Tensor,
                              exp_avg_sq: torch.Tensor, step: torch.Tensor,
                              *, lr: float, beta1: float, beta2: float,
                              eps: float, weight_decay: float = 0.0,
                              decoupled: bool = False,
                              found_inf: Optional[torch.Tensor] = None
                              ) -> None:
    """Plain PyTorch version, in place: the dense gradient (each id's
    rows summed in lookup order, `_lookup_order_sum`), then the module
    docstring's step over every row in float32, each fma through float64
    (`_fma`). Reads found_inf and the longest run of an id on the
    host."""
    _check(param, grad, exp_avg, exp_avg_sq, step, found_inf)
    t = step + 1
    skip = found_inf is not None and float(found_inf) == 1.0
    step.copy_(t - found_inf if found_inf is not None else t)
    if skip:
        return

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    lr_, b1, b2, wd, eps_ = (f32(x) for x in (lr, beta1, beta2,
                                               weight_decay, eps))
    step_size = lr_ / (1 - torch.pow(b1, t))
    bias_correction2_sqrt = torch.sqrt(1 - torch.pow(b2, t))
    g, p = _lookup_order_sum(grad), param
    if weight_decay != 0:
        if decoupled:
            p = _fma(-(lr_ * wd), p, p)
        else:
            g = _fma(p, wd, g)
    m = _fma(b1, exp_avg, _fma(-b1, g, g))
    gg = g * g
    v = _fma(b2, exp_avg_sq, _fma(-b2, gg, gg))
    denom = torch.sqrt(v) / bias_correction2_sqrt + eps_
    param.copy_(p - step_size * m / denom)
    exp_avg.copy_(m)
    exp_avg_sq.copy_(v)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("row_sparse_adam").row_sparse_adam_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_sparse_adam(param: torch.Tensor, grad: torch.Tensor,
                    exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                    step: torch.Tensor, *, lr: float, beta1: float,
                    beta2: float, eps: float, weight_decay: float = 0.0,
                    decoupled: bool = False,
                    found_inf: Optional[torch.Tensor] = None) -> None:
    """One Adam step of `param` [N, D] and its state (exp_avg,
    exp_avg_sq, step), in place, from the row-sparse `grad` (see the
    module docstring). decoupled: AdamW's weight decay, else Adam's L2
    term. lr, beta1, beta2, eps and weight_decay are taken in float32,
    as torch's fused kernel takes them.

    Every kernel launch adds one to `row_sparse_adam.launches`; the CPU
    path launches nothing."""
    _check(param, grad, exp_avg, exp_avg_sq, step, found_inf)
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, decoupled=decoupled,
              found_inf=found_inf)
    if param.device.type == "cpu":
        row_sparse_adam_reference(param, grad, exp_avg, exp_avg_sq, step,
                                  **kw)
        return
    if param.device.type != "cuda":
        raise ValueError(f"row_sparse_adam runs on cuda or cpu, not "
                         f"{param.device}")
    ids, values = grad._indices()[0], grad._values().contiguous()
    if ids.numel() > _MAX_NNZ:
        raise ValueError(f"row_sparse_adam takes at most {_MAX_NNZ} ids, "
                         f"got {ids.numel()}")
    with torch.cuda.device(param.device):
        sorted_ids, order = torch.sort(ids, stable=True)
        scratch = torch.empty(param.shape[0] + 2, dtype=torch.int32,
                              device=param.device)
        _launch(param, values, sorted_ids, order, scratch, exp_avg,
                exp_avg_sq, step, **kw)


def _launch(param: torch.Tensor, values: torch.Tensor,
            sorted_ids: torch.Tensor, order: torch.Tensor,
            scratch: torch.Tensor, exp_avg: torch.Tensor,
            exp_avg_sq: torch.Tensor, step: torch.Tensor, *, lr: float,
            beta1: float, beta2: float, eps: float, weight_decay: float,
            decoupled: bool, found_inf: Optional[torch.Tensor]) -> None:
    """One launch on the current stream, counted: row_sparse_adam has
    checked the tensors, sorted the ids and made the int32 scratch
    [N + 2] (the row map, then two floats)."""
    rows, dim = param.shape
    ptrs = [t.data_ptr() for t in (param, exp_avg, exp_avg_sq, values)]
    vec = 4 if dim % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1
    rc = _kernel_fn()(
        param.data_ptr(), exp_avg.data_ptr(), exp_avg_sq.data_ptr(),
        values.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
        scratch.data_ptr(), step.data_ptr(),
        found_inf.data_ptr() if found_inf is not None else None,
        rows, dim, sorted_ids.numel(), vec, int(decoupled), lr, beta1,
        beta2, weight_decay, eps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_sparse_adam kernel launch failed: CUDA "
                           f"error {rc}")
    row_sparse_adam.launches += 1


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two float32 tensors of one shape, in
    float32 steps (0: the same bits, -0 and +0 apart by 0): the yardstick
    the kernel is held to against the plain version and torch's fused
    Adam."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


row_sparse_adam.launches = 0
