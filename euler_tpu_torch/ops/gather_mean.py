"""Fused neighbor gather + mean (counterpart of euler_tpu/ops/pallas_ops.py).

    out[i] = mean_j table[rows[i, j]]          rows: [n, k] int32

without building the [n*k, D] gathered layer. With an int8 table the
per-column dequant of the feature store is fused in:

    out[i] = (sum_j table[rows[i, j]]) * (1/k) * scale   (out in scale.dtype)

A float table's output is in its dtype, or float32 for a bfloat16
table when the caller asks (`out_dtype=torch.float32`): the reference
upcasts each row of a bfloat16 activation cache to float32 before its
mean (euler_tpu/utils/encoders.py:_ScalableCache), and the float32 sum
is then stored without a bfloat16 rounding.

A row index follows `jnp.take`'s default (mode="fill"), as the
reference's gather does: an index in [-N, -1] reads row N + i, and an
index >= N or < -N reads the fill value, NaN for a float table (so the
output row is NaN) and -128 for an int8 table (summed with the other
rows, then scaled). `take_rows` is that rule in plain PyTorch.

On a CUDA tensor `gather_mean` launches the hand-written kernel
(csrc/gather_mean.cu) with the plan `launch_plan` picks from the real
pointers and shapes, or raises; on a CPU tensor it runs the plain
PyTorch version, `gather_mean_reference`. There is no other route.

The reference's int8 path dequantizes each gathered row before the
mean (euler_tpu/models/graphsage.py:gather_feature_rows); scaling after
the float32 sum differs from it by rounding only: at most one rounding
of the output type (one bf16 ulp of the largest value with a bf16 scale).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from euler_tpu_torch.kernels import _build

# dtype codes shared with csrc/gather_mean.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NO_SCALE = -1
_WARP = 32
_ROWS_PER_BLOCK = 4  # warps per block (chip_smoke.py's plan sweep)
_MAX_ROWS_PER_BLOCK = 16  # the kernel's launch bound: 512 threads
_MAX_TABLE_ROWS = 2 ** 31 - 1  # the kernel wraps indices in int32
_MAX_COL_BLOCKS = 65535  # gridDim.y


def _check(table: torch.Tensor, rows: torch.Tensor,
           scale: Optional[torch.Tensor],
           out_dtype: Optional[torch.dtype] = None) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be [N, D], got {tuple(table.shape)}")
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"rows must be [n, k] with k >= 1, got "
                         f"{tuple(rows.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if table.dtype == torch.int8:
        if scale is None:
            raise TypeError("an int8 table needs its per-column scale")
        if scale.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"scale must be float32 or bfloat16, got "
                            f"{scale.dtype}")
        if scale.shape != (table.shape[1],):
            raise ValueError(f"scale must be [{table.shape[1]}], got "
                             f"{tuple(scale.shape)}")
    elif table.dtype in (torch.float32, torch.bfloat16):
        if scale is not None:
            raise TypeError("a scale applies to an int8 table only")
    else:
        raise TypeError(f"table must be int8, float32 or bfloat16, got "
                        f"{table.dtype}")
    natural = table.dtype if scale is None else scale.dtype
    if out_dtype not in (None, natural) and not (
            table.dtype == torch.bfloat16 and out_dtype == torch.float32):
        raise TypeError(f"out_dtype {out_dtype} is not taken for a "
                        f"{table.dtype} table whose output is {natural}: "
                        "only a bfloat16 table may ask for float32")
    tensors = [table, rows] + ([scale] if scale is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, rows and scale must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, rows and scale must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise ValueError("gather_mean has no backward: the feature table "
                         "is an input of the forward, not a parameter")


def _out_dtype(table: torch.Tensor, scale: Optional[torch.Tensor],
               out_dtype: Optional[torch.dtype] = None):
    if out_dtype is not None:
        return out_dtype
    return table.dtype if scale is None else scale.dtype


def take_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[rows] with jnp.take's fill semantics (axis 0, mode="fill"):
    [-N, -1] wraps to N + i, anything else outside [0, N) gives the
    fill value (NaN for a float table, the type's minimum for an
    integer one). Never raises on an index; an empty table raises
    IndexError, as jnp.take does. Cost: a few passes over the indices
    and one masked fill over the gathered rows."""
    n = table.shape[0]
    if n == 0 and rows.numel():
        raise IndexError("take_rows from an empty table")
    fill = (float("nan") if table.dtype.is_floating_point
            else torch.iinfo(table.dtype).min)
    r = rows.long()
    bad = (r >= n) | (r < -n)
    out = table[r.masked_fill(bad, 0)]  # torch indexing wraps [-N, -1]
    return out.masked_fill_(bad.view(*bad.shape, *[1] * (table.dim() - 1)),
                            fill)


def gather_mean_reference(table: torch.Tensor, rows: torch.Tensor,
                          scale: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: take_rows in float32, mean over k, then
    the scale, then the cast to the output dtype."""
    _check(table, rows, scale, out_dtype)
    m = take_rows(table, rows).to(torch.float32).mean(1)
    if scale is not None:
        m = m * scale.to(torch.float32)
    return m.to(_out_dtype(table, scale, out_dtype))


class LaunchPlan(NamedTuple):
    """How the kernel covers out [n, D]: a warp per (output row, chunk of
    `lanes` vectors), whose first `lanes` lanes each load `vec_bytes` of
    a table row (`elems` elements) per neighbor. A row has
    `vectors_per_row` vectors, so ceil(vectors_per_row / lanes) chunks,
    spread over `col_blocks` grid rows; `rows_per_block` warps per block
    and `grid` blocks along the rows, grid-strided over the n rows."""
    vec_bytes: int
    elems: int
    vectors_per_row: int
    lanes: int
    rows_per_block: int
    grid: int
    col_blocks: int


def launch_plan(table: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                rows_per_block: int = _ROWS_PER_BLOCK) -> LaunchPlan:
    """The kernel's plan for these tensors, from their real pointers.

    vec_bytes is the widest of 16, 8, 4, 2 and 1 bytes such that one
    lane's elems = vec_bytes / table.element_size() elements divide the
    row (D % elems == 0), the table's address is a multiple of
    vec_bytes, and the same elems elements of the output (and of the
    scale) take at most 16 bytes and are aligned at its address.
    lanes = min(D / elems, 32); a row of more than 32 vectors is cut
    into col_blocks chunks of 32, one warp each. grid =
    ceil(n / rows_per_block): a warp per (row, chunk)."""
    if not 1 <= rows_per_block <= _MAX_ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block must be in [1, "
                         f"{_MAX_ROWS_PER_BLOCK}], got {rows_per_block}")
    n, d = rows.shape[0], table.shape[1]
    es, os_ = table.element_size(), out.element_size()
    for vec in (16, 8, 4, 2, 1):
        e = vec // es
        if e == 0 or d % e or table.data_ptr() % vec:
            continue
        if e * os_ > 16 or out.data_ptr() % (e * os_):
            continue
        if scale is not None:
            sb = e * scale.element_size()
            if sb > 16 or scale.data_ptr() % sb:
                continue
        break
    vectors = d // e
    lanes = min(vectors, _WARP)
    col_blocks = min(-(-vectors // lanes), _MAX_COL_BLOCKS)
    grid = max(1, -(-n // rows_per_block))
    return LaunchPlan(vec, e, vectors, lanes, rows_per_block,
                      min(grid, 2 ** 31 - 1), col_blocks)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("gather_mean").gather_mean_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_mean(table: torch.Tensor, rows: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out [n, D] = mean over k of table[rows] (see module docstring).
    out_dtype: float32 for a bfloat16 table's float32 output; else the
    default (the scale's dtype for an int8 table, the table's for a
    float one).

    Every kernel launch adds one to `gather_mean.launches`; the CPU path
    and empty inputs launch nothing."""
    _check(table, rows, scale, out_dtype)
    if table.device.type == "cpu":
        return gather_mean_reference(table, rows, scale, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"gather_mean runs on cuda or cpu, not "
                         f"{table.device}")
    n, k = rows.shape
    out = torch.empty((n, table.shape[1]),
                      dtype=_out_dtype(table, scale, out_dtype),
                      device=table.device)
    if out.numel() == 0:
        return out
    if table.shape[0] == 0:
        raise IndexError("gather_mean from an empty table")
    if table.shape[0] > _MAX_TABLE_ROWS:
        raise ValueError(f"gather_mean takes at most {_MAX_TABLE_ROWS} "
                         f"table rows, got {table.shape[0]}")
    with torch.cuda.device(table.device):
        _launch(table, rows, scale, out, launch_plan(table, rows, out, scale))
    return out


def _launch(table: torch.Tensor, rows: torch.Tensor,
            scale: Optional[torch.Tensor], out: torch.Tensor,
            plan: LaunchPlan) -> None:
    """One launch into `out` on the current stream, counted. gather_mean
    has checked the tensors and made `out` [n, D] in the output dtype,
    which the kernel takes from `out`; the kernel checks the plan
    against the pointers."""
    n, k = rows.shape
    rc = _kernel_fn()(
        table.data_ptr(), _DTYPE_CODES[table.dtype], rows.data_ptr(),
        scale.data_ptr() if scale is not None else None,
        _DTYPE_CODES[scale.dtype] if scale is not None else _NO_SCALE,
        out.data_ptr(), _DTYPE_CODES[out.dtype], n, k, table.shape[1],
        table.shape[0], plan.vec_bytes, plan.lanes, plan.rows_per_block, plan.grid,
        plan.col_blocks, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_mean kernel launch failed: CUDA error "
                           f"{rc} ({plan})")
    gather_mean.launches += 1


gather_mean.launches = 0
