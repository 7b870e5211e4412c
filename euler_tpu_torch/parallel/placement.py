"""Device placement of input tables (counterpart of
euler_tpu/parallel/placement.py:25-62), one module so the table classes
cannot diverge:

- put_replicated: every rank holds the whole table; gathers stay local.
- put_row_sharded: the rows split over the mesh's 'model' axis, padded
  with zero rows to a multiple of it (the reference's rule: the pad rows
  sit past the table's own trailing pad row, so no live index reaches
  them); rank r of a model group keeps rows [r·per, (r+1)·per). The
  tensor carries `row_shard` (its offset, its rows and the padded
  global row count), which device_sampler.make_table_gather reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from euler_tpu_torch.platform import DeviceLike, resolve_device


@dataclass(frozen=True)
class RowShard:
    """This rank's rows [lo, lo + rows) of a table of global_rows rows
    (data_rows padded to a multiple of the axis), row-sharded over
    `axis` of `mesh`."""
    lo: int
    rows: int
    global_rows: int
    axis: str = "model"
    mesh: Any = field(default=None, compare=False)
    data_rows: int = -1   # the table's rows before padding


def row_shard(t) -> Optional[RowShard]:
    """The RowShard a row-sharded tensor carries, else None."""
    return getattr(t, "row_shard", None)


def _device(mesh, device: DeviceLike) -> torch.device:
    return mesh.device if mesh is not None else resolve_device(device)


def _upload(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, copy=True)


def put_replicated(x, mesh=None, device: DeviceLike = None) -> torch.Tensor:
    """The whole table on this rank's device (the mesh's, else
    `device`), in memory of its own."""
    return _upload(x, _device(mesh, device))


def pad_rows(x, mp: int):
    """x with zero rows appended up to a multiple of mp."""
    pad = (-x.shape[0]) % mp
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def put_row_sharded(x, mesh, axis: str = "model",
                    device: DeviceLike = None) -> torch.Tensor:
    """This rank's rows of x over `axis`; replicated when the mesh has
    no (or a trivial) model axis."""
    if mesh is None or mesh.size(axis) <= 1:
        return put_replicated(x, mesh, device)
    mp = mesh.size(axis)
    n = int(x.shape[0])
    x = pad_rows(x, mp)
    per = x.shape[0] // mp
    lo = mesh.index(axis) * per
    t = _upload(x[lo:lo + per], mesh.device)
    t.row_shard = RowShard(lo, per, int(x.shape[0]), axis, mesh, n)
    return t
