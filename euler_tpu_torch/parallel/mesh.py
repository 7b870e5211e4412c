"""The ('data', 'model') device mesh (counterpart of
euler_tpu/parallel/mesh.py:27-110).

The reference is one controller over a jax Mesh; the port is one
process per device over torch.distributed, and the mesh is a
DeviceMesh of those processes with the reference's axis names:

- 'data' shards the batch of a model that splits over it
  (parallel.train.splits_over_data): each rank keeps its slice of
  every batch array (shard_batch), and parameter gradients are summed
  over the data group; any other model takes the whole batch on every
  data rank;
- 'model' row-shards the tables (placement.put_row_sharded): rank r of
  a model group holds rows [r·per, (r+1)·per), and every rank of a
  model group holds the same data slice.

Rank r sits at data index r // mp and model index r % mp. The devices
are CUDA with NCCL unless the caller asks for the CPU (device="cpu"),
which uses gloo; nothing falls back from one to the other. make_mesh
starts the process group when none is running: from the environment
(multihost.MultihostConfig.from_env), else as a world of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch.platform import DeviceLike, host_to_device, resolve_device

__all__ = ["Mesh", "make_mesh", "data_sharding", "replicated", "shard_batch",
           "data_slice", "mesh_shape_for", "REPLICATED_TABLE_KEYS"]

AXES = ("data", "model")
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    assert n_devices % model_parallel == 0
    return (n_devices // model_parallel, model_parallel)


class Mesh:
    """A DeviceMesh over ("data", "model") and the device this rank
    drives. shape: {"data": dp, "model": mp}, as dict(jax_mesh.shape)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        dims = tuple(device_mesh.mesh.shape)
        self.shape: Dict[str, int] = dict(zip(AXES, (int(d) for d in dims)))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {dist.get_rank()}, "
                f"{self.device})")


def make_mesh(model_parallel: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh of every rank of the process group, model_parallel ranks
    a model group. device None is this rank's CUDA device (NCCL);
    "cpu" uses gloo. Every rank calls it with the same arguments."""
    from torch.distributed.device_mesh import init_device_mesh

    from euler_tpu_torch.parallel.multihost import initialize_multihost

    dev = resolve_device(device)
    if not dist.is_initialized():
        initialize_multihost(device=dev)
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise RuntimeError(
            f"the process group runs {backend}, a {dev.type} mesh needs "
            f"{_BACKEND[dev.type]}")
    # "cuda" is this rank's card (initialize_multihost set it current),
    # as the port's tables and models name it
    dp, mp = mesh_shape_for(dist.get_world_size(), int(model_parallel))
    dm = init_device_mesh(dev.type, (dp, mp), mesh_dim_names=AXES)
    return Mesh(dm, dev)


@dataclass(frozen=True)
class Placement:
    """A placement descriptor, as a NamedSharding's spec: `spec` names
    the mesh axis each leading dimension is split over (() is
    replicated)."""
    mesh: Any
    spec: Tuple = ()


def data_sharding(mesh: Mesh) -> Placement:
    """Batch arrays: leading axis over 'data'."""
    return Placement(mesh, ("data",))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


# batch keys that carry device-resident tables rather than per-step data
# (reference REPLICATED_TABLE_KEYS): never split over 'data'; a table
# the caller row-sharded over 'model' keeps its placement
REPLICATED_TABLE_KEYS = ("feature_table", "feature_scale", "label_table",
                         "nbr_table", "cum_table", "nbrcum_table",
                         "alias_table", "hub_cache")


def _slice_leaf(key: str, v, dp: int, d: int):
    shape = getattr(v, "shape", None)
    if shape is None or len(shape) == 0:
        return v
    if shape[0] % dp:
        raise ValueError(
            f"batch[{key!r}] has {shape[0]} rows, which the data axis "
            f"({dp}) does not divide: every per-step array is split over "
            f"it (tables go in the replicated keys)")
    n = shape[0] // dp
    return v[d * n:(d + 1) * n]


def data_slice(batch: Dict[str, Any], mesh: Mesh,
               replicated_keys=REPLICATED_TABLE_KEYS) -> Dict[str, Any]:
    """This rank's slice of every batch array (numpy or tensor, in lists
    too) along its leading dimension; scalars, and the table keys, as
    they are. Host arrays stay on the host. An array whose leading
    dimension the data axis does not divide raises: the reference's
    GSPMD replicates it and keeps the global batch's semantics, a rank
    here would read it as its own rows."""
    dp, d = mesh.size("data"), mesh.index("data")
    if dp == 1:
        return dict(batch)

    def walk(k, v):
        if isinstance(v, (list, tuple)):
            return type(v)(walk(k, x) for x in v)
        return _slice_leaf(k, v, dp, d)

    return {k: v if k in replicated_keys else walk(k, v)
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                replicated_keys=REPLICATED_TABLE_KEYS) -> Dict[str, Any]:
    """data_slice, then every array on the mesh's device: per-step
    arrays as this rank's slice, host tables replicated,
    tables already on the device (a row-sharded one included) as they
    are. Scalars stay host values."""
    out = data_slice(batch, mesh, replicated_keys)

    def put(v):
        if isinstance(v, (list, tuple)):
            return type(v)(put(x) for x in v)
        if isinstance(v, torch.Tensor):
            return v.to(mesh.device)
        if isinstance(v, np.ndarray) and v.ndim and v.dtype != np.uint64:
            return host_to_device(np.ascontiguousarray(v), mesh.device)
        return v

    return {k: put(v) for k, v in out.items()}
