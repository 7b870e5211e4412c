"""Operations and bytes of the work a step needs, counted from shapes.

The benchmark's yardstick: the counts stay fixed when the program
changes, so a roofline share or a model-FLOP share can only rise by
less time, never by a different count.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import torch

PEAKS_FILE = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of a card by its torch.cuda.get_device_name(),
    None for a card the table lacks."""
    return json.loads(PEAKS_FILE.read_text()).get(kind)


def gather_mean_bound(table: torch.Tensor, rows: torch.Tensor,
                      scale: Optional[torch.Tensor], out_dtype: torch.dtype,
                      peak: dict) -> dict:
    """Least time for one gather_mean launch: each distinct table row it
    reads, the indices and the scale read once, the output written once;
    the adds and multiplies at the float32 rate.

    Frozen copy of chip_smoke.py:721-740 (gather_mean_bound), the peaks
    taken from `peak` (peaks.json) instead of module constants."""
    n, k = rows.shape
    d = table.shape[1]
    distinct = int(torch.unique(rows).numel())
    nbytes = (rows.numel() * rows.element_size()
              + distinct * d * table.element_size()
              + (scale.numel() * scale.element_size() if scale is not None
                 else 0)
              + n * d * torch.tensor([], dtype=out_dtype).element_size())
    ops = n * k * d + 2 * n * d
    t_bytes = nbytes / peak["hbm_bytes_per_s"] * 1e3
    t_ops = ops / peak["f32_flops_per_s"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "distinct_rows": distinct}


def payload_bytes(table: torch.Tensor, rows: torch.Tensor,
                  out_dtype: torch.dtype) -> int:
    """What a gather_mean launch moves as it gathers: every (row,
    neighbor) row read whole, the indices, the output (the bound counts
    distinct rows instead).

    Frozen copy of chip_smoke.py:915-924 (payload_bytes)."""
    n, k = rows.shape
    d = table.shape[1]
    return (n * k * d * table.element_size() + rows.numel() * 4
            + n * d * torch.tensor([], dtype=out_dtype).element_size())


def dense_flops(rows: int, fan_in: int, fan_out: int, passes: int) -> int:
    """2·rows·fan_in·fan_out for each pass of one dense layer: 1 forward
    only, 2 with the weight gradient, 3 with the input gradient too."""
    return 2 * rows * fan_in * fan_out * passes


def sage_step_flops(batch: int, fanouts: Sequence[int], in_dim: int,
                    dim: int, concat: bool, head: int, head_kind: str) -> int:
    """Model FLOPs of one training step of a mean-aggregator GraphSAGE
    over a sampled fanout: the dense layers' GEMMs, forward and backward,
    nothing recomputed. Depth d's aggregator runs on hops 0 ..
    L-1-d (batch·prod(fanouts[:h]) rows each), with a self and a
    neighbor transform; depth 0 reads features, which take no gradient
    (2 passes), every deeper layer 3; concat: the self and neighbor
    transforms side by side (the next layer twice as wide) or summed.
    head_kind "logits": a dense layer of `head` outputs over the
    embedding (the supervised model's classes); "scores": `head`
    embedding-width dot products a root against context rows (the
    unsupervised model's 1 + negatives), forward and both gradients.
    The means and elementwise passes are not counted."""
    total, width = 0, in_dim
    hops = len(fanouts)
    for depth in range(hops):
        rows = sum(batch * _prod(fanouts[:h]) for h in range(hops - depth))
        passes = 2 if depth == 0 else 3
        total += 2 * dense_flops(rows, width, dim, passes)
        width = 2 * dim if concat else dim
    if head_kind == "logits":
        total += dense_flops(batch, width, head, 3)
    elif head_kind == "scores":
        total += 2 * batch * head * width * 3
    else:
        raise ValueError(f"unknown head kind {head_kind!r}")
    return total


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out
