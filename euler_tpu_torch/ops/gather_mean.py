"""Fused neighbor gather + mean (counterpart of euler_tpu/ops/pallas_ops.py).

    out[i] = mean_j table[rows[i, j]]          rows: [n, k] int32

without building the [n*k, D] gathered layer. With an int8 table the
per-column dequant of the feature store is fused in:

    out[i] = (sum_j table[rows[i, j]]) * (1/k) * scale   (out in scale.dtype)

On a CUDA tensor `gather_mean` launches the hand-written kernel
(csrc/gather_mean.cu) or raises; on a CPU tensor it runs the plain
PyTorch version, `gather_mean_reference`. There is no other route.

The reference's int8 path dequantizes each gathered row before the
mean (euler_tpu/models/graphsage.py:gather_feature_rows); scaling after
the float32 sum differs from it by rounding only: at most one rounding
of the output type (one bf16 ulp of the largest value with a bf16 scale).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from euler_tpu_torch.kernels import _build

# dtype codes shared with csrc/gather_mean.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_NO_SCALE = -1


def _check(table: torch.Tensor, rows: torch.Tensor,
           scale: Optional[torch.Tensor]) -> None:
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
    tensors = [table, rows] + ([scale] if scale is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, rows and scale must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table, rows and scale must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise ValueError("gather_mean has no backward: the feature table "
                         "is an input of the forward, not a parameter")


def _out_dtype(table: torch.Tensor, scale: Optional[torch.Tensor]):
    return table.dtype if scale is None else scale.dtype


def gather_mean_reference(table: torch.Tensor, rows: torch.Tensor,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version: table[rows] in float32, mean over k, then
    the scale, then the cast to the output dtype."""
    _check(table, rows, scale)
    m = table[rows.long()].to(torch.float32).mean(1)
    if scale is not None:
        m = m * scale.to(torch.float32)
    return m.to(_out_dtype(table, scale))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("gather_mean").gather_mean_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_mean(table: torch.Tensor, rows: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [n, D] = mean over k of table[rows] (see module docstring).

    Every kernel launch adds one to `gather_mean.launches`; the CPU path
    and empty inputs launch nothing."""
    _check(table, rows, scale)
    if table.device.type == "cpu":
        return gather_mean_reference(table, rows, scale)
    if table.device.type != "cuda":
        raise ValueError(f"gather_mean runs on cuda or cpu, not "
                         f"{table.device}")
    n, k = rows.shape
    out = torch.empty((n, table.shape[1]), dtype=_out_dtype(table, scale),
                      device=table.device)
    if out.numel() == 0:
        return out
    if table.shape[0] == 0:
        raise ValueError("gather_mean from an empty table")
    with torch.cuda.device(table.device):
        rc = _kernel_fn()(
            table.data_ptr(), _DTYPE_CODES[table.dtype], rows.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            _DTYPE_CODES[scale.dtype] if scale is not None else _NO_SCALE,
            out.data_ptr(), n, k, table.shape[1], table.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_mean kernel launch failed: CUDA error "
                           f"{rc}")
    gather_mean.launches += 1
    return out


gather_mean.launches = 0
