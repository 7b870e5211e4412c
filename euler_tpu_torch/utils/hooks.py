"""Distributed worker coordination hooks (counterpart of
euler_tpu/utils/hooks.py:21-86; the reference's SyncExitHook, workers
blocking at the end of training until every worker arrives).

sync_exit() is a barrier over the process group (a no-op in a world of
one); FileBarrier is a copy of the reference's file rendezvous over a
shared directory, for workers outside one process group.
"""

from __future__ import annotations

import os
import time


def sync_exit(name: str = "exit") -> None:
    """Block until every rank of the process group reaches this point
    (a no-op without a group or in a world of one)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    dist.barrier()


class FileBarrier:
    """N-party rendezvous over a shared filesystem directory (copy of
    euler_tpu/utils/hooks.py:FileBarrier).

    Each worker calls wait(worker_id); returns once all num_workers have
    arrived. Reusable across rounds via the round counter.

    Marker files are namespaced by run_id — every worker of one job must
    pass the SAME run_id (e.g. the coordinator-assigned job id), and a
    restarted job must use a fresh one (or a fresh directory): stale
    markers from a crashed run would otherwise satisfy the count
    immediately. Files from two rounds back are garbage-collected (by
    then every worker has provably passed them).
    """

    def __init__(self, directory: str, num_workers: int,
                 run_id: str = "0", poll_ms: int = 100,
                 timeout_s: float = 600.0):
        self.dir = directory
        self.num_workers = num_workers
        self.run_id = run_id
        self.poll_ms = poll_ms
        self.timeout_s = timeout_s
        self._round = 0
        os.makedirs(directory, exist_ok=True)

    def _tag(self, rnd: int) -> str:
        return f"barrier_{self.run_id}_{rnd}_"

    def wait(self, worker_id: int) -> None:
        tag = self._tag(self._round)
        mine = os.path.join(self.dir, f"{tag}{worker_id}")
        with open(mine, "w"):
            pass
        # monotonic, not wall-clock: an NTP step during the wait must not
        # spuriously expire (or indefinitely extend) an exit barrier
        deadline = time.monotonic() + self.timeout_s
        while True:
            n = sum(1 for f in os.listdir(self.dir) if f.startswith(tag))
            if n >= self.num_workers:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"barrier timed out: {n}/{self.num_workers} arrived")
            time.sleep(self.poll_ms / 1000.0)
        # entering round r proves all workers passed r-1, so nobody can
        # still be counting r-2 — safe to reclaim those markers
        if self._round >= 2:
            old = self._tag(self._round - 2)
            for f in os.listdir(self.dir):
                if f.startswith(old):
                    try:
                        os.remove(os.path.join(self.dir, f))
                    except OSError:
                        pass
        self._round += 1
