"""Embedding tables row-sharded over the mesh's 'model' axis
(counterpart of euler_tpu/parallel/sharded_embedding.py:32-133).

A ShardedEmbedding is built whole on every rank (the same generator,
the same rows) and apply_param_shardings then keeps each rank's rows
(placement.put_row_sharded's rule). `lookup` picks how the rows are
fetched:

  'gspmd'      the masked local take and one SUM over 'model'
               (device_sampler.make_table_gather), the reference's
               default GSPMD lookup;
  'ring'       ring_exchange.ring_lookup on this rank's block of the
               ids, the blocks then all-gathered over 'model';
  'allgather'  ring_exchange.allgather_lookup likewise.

The three give the same rows and the same gradients (up to the order
a row's contributions are added). 'ring' and 'allgather' need
num_embeddings divisible by the axis, as the reference's do. An
unsharded table (no mesh, or a trivial model axis) is a plain take.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.mesh import Placement
from euler_tpu_torch.parallel.placement import (
    RowShard, pad_rows, row_shard,
)
from euler_tpu_torch.utils.layers import bucketize_ids

__all__ = ["ShardedEmbedding", "param_shardings", "apply_param_shardings"]

_LOOKUPS = ("gspmd", "ring", "allgather")


class ShardedEmbedding(nn.Module):
    """Parameter "table" [num_embeddings, dim], U[0, init_scale) from
    the caller's generator (flax's uniform init, as utils.layers.
    Embedding), its rows partitioned over `partition_axis`
    (table.partition, the reference's flax partitioning metadata)."""

    def __init__(self, num_embeddings: int, dim: int,
                 init_scale: float = 0.05, partition_axis: str = "model",
                 lookup: str = "gspmd", mesh=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.dim = int(dim)
        self.partition_axis = partition_axis
        self.lookup = lookup
        self.mesh = mesh
        self.table = nn.Parameter(
            torch.rand((self.num_embeddings, dim), generator=generator)
            * init_scale)
        self.table.partition = (partition_axis, None)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.lookup not in _LOOKUPS:
            raise ValueError(
                f"ShardedEmbedding.lookup must be 'gspmd', 'ring' or "
                f"'allgather', got {self.lookup!r}")
        rows = bucketize_ids(ids, self.num_embeddings)
        info = row_shard(self.table)
        if info is None:
            return F.embedding(rows.long(), self.table)
        from euler_tpu_torch.parallel.device_sampler import make_table_gather

        mesh, axis = self.mesh, self.partition_axis
        if self.lookup == "gspmd":
            return make_table_gather(mesh, axis)(self.table, rows)
        k = mesh.size(axis)
        if self.num_embeddings % k:
            raise ValueError(
                f"ShardedEmbedding.lookup={self.lookup!r} needs "
                f"num_embeddings ({self.num_embeddings}) divisible by "
                f"the '{axis}' axis size {k}")
        from euler_tpu_torch.parallel.ring_exchange import (
            allgather_lookup, ring_lookup,
        )

        fn = ring_lookup if self.lookup == "ring" else allgather_lookup
        flat = rows.reshape(-1)
        pad = (-flat.shape[0]) % k
        if pad:  # id blocks must divide evenly; pads read row 0
            flat = torch.cat([flat, flat.new_zeros(pad)])
        n = flat.shape[0] // k
        me = mesh.index(axis)
        block = fn(self.table, flat[me * n:(me + 1) * n], mesh, axis)
        out = collectives.gather_replicated(block, mesh.group(axis))
        if pad:
            out = out[:-pad]
        return out.reshape(tuple(rows.shape) + (self.dim,))


def param_shardings(model: nn.Module, mesh) -> Dict[str, Placement]:
    """{parameter name: Placement}: rows over the partition axis for a
    parameter with partitioning metadata, replicated for the rest."""
    return {name: Placement(mesh, tuple(getattr(p, "partition", ())))
            for name, p in model.named_parameters()}


def apply_param_shardings(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's rows of every partitioned parameter (zero rows
    padded to a multiple of the axis, as put_row_sharded pads) and bind
    its modules to the mesh; on mesh.device. Call before the optimizer
    is built. A trivial axis keeps the whole table."""
    model.to(mesh.device)
    for mod in model.modules():
        if isinstance(mod, ShardedEmbedding):
            mod.mesh = mesh
    for p in model.parameters():
        spec = getattr(p, "partition", None)
        if not spec or row_shard(p) is not None:
            continue
        axis = spec[0]
        mp = mesh.size(axis)
        if mp <= 1:
            continue
        with torch.no_grad():
            n = int(p.shape[0])
            full = pad_rows(p.data, mp)
            per = full.shape[0] // mp
            lo = mesh.index(axis) * per
            p.data = full[lo:lo + per].clone()
        p.row_shard = RowShard(lo, per, int(full.shape[0]), axis, mesh, n)
    return model
