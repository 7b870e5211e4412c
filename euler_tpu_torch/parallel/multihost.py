"""Starting and ending the process group of a multi-device run
(counterpart of euler_tpu/parallel/multihost.py:33-121).

The reference joins one jax.distributed job per host; the port runs one
process per device and joins them in one torch.distributed group: NCCL
on the card, gloo on the CPU (device="cpu", the tests' world). Launch N
ranks with torchrun (`torchrun --nproc_per_node N script.py`: RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or set the
reference's EULER_TPU_COORDINATOR ("host:port" of rank 0),
EULER_TPU_NUM_HOSTS and EULER_TPU_HOST_IDX for each process (and
LOCAL_RANK, the card a process drives on its host). Without either, a
process is a world of one on a free 127.0.0.1 port.

    initialize_multihost()                 # from the environment
    mesh = make_mesh(model_parallel=2)     # parallel/mesh.py
    ... train ...
    finalize_multihost(barrier_dir)        # exit rendezvous
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from euler_tpu_torch.platform import DeviceLike, resolve_device


@dataclass
class MultihostConfig:
    coordinator: str          # "host:port" of rank 0
    num_processes: int
    process_id: int
    local_rank: int = 0       # the CUDA device this process drives

    @classmethod
    def from_env(cls) -> "MultihostConfig":
        """EULER_TPU_COORDINATOR / _NUM_HOSTS / _HOST_IDX (the
        reference's launcher variables), else torchrun's RANK /
        WORLD_SIZE / MASTER_ADDR / MASTER_PORT; KeyError when neither
        is set. LOCAL_RANK (default 0) picks the card."""
        env = os.environ
        local = int(env.get("LOCAL_RANK", 0))
        if "EULER_TPU_COORDINATOR" in env:
            return cls(env["EULER_TPU_COORDINATOR"],
                       int(env["EULER_TPU_NUM_HOSTS"]),
                       int(env["EULER_TPU_HOST_IDX"]), local)
        return cls(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                   int(env["WORLD_SIZE"]), int(env["RANK"]), local)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(cfg: Optional[MultihostConfig] = None,
                         device: DeviceLike = None) -> int:
    """Joins the process group and returns this process's rank: cfg,
    else the environment (MultihostConfig.from_env), else a world of
    one. device None: NCCL, this process bound to cuda:local_rank
    (raises without a card); "cpu": gloo. A running group is kept."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank()
    if cfg is None:
        try:
            cfg = MultihostConfig.from_env()
        except KeyError:
            cfg = MultihostConfig(f"127.0.0.1:{free_port()}", 1, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(cfg.local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{cfg.coordinator}",
        world_size=cfg.num_processes, rank=cfg.process_id)
    return cfg.process_id


def finalize_multihost(barrier_dir: Optional[str] = None,
                       cfg: Optional[MultihostConfig] = None,
                       run_id: str = "exit") -> None:
    """Worker exit rendezvous (reference SyncExitHook): with a
    barrier_dir every rank waits at a FileBarrier there, then the group
    ends. Nothing to do when no group runs."""
    if not dist.is_initialized():
        return
    if barrier_dir and dist.get_world_size() > 1:
        from euler_tpu_torch.utils.hooks import FileBarrier

        n = cfg.num_processes if cfg else dist.get_world_size()
        pid = cfg.process_id if cfg else dist.get_rank()
        FileBarrier(barrier_dir, n, run_id=run_id).wait(pid)
    dist.destroy_process_group()


def process_batch_slice(global_batch: int, mesh=None) -> slice:
    """This process's rows of a global batch: its data slice on `mesh`
    (every rank of a model group shares one), else its rank's slice of
    the world."""
    if mesh is not None:
        n, i = mesh.size("data"), mesh.index("data")
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
