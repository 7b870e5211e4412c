"""The training feed: batches of root rows drawn from a seed, and the gate
that closes the measured window on a whole K-step replay.

RootFeed walks shuffled epochs over a pool of rows (the training split,
or every node): each batch is the next `batch` rows of the epoch's
permutation, so the rows of a batch all differ, and a short last batch
of an epoch is dropped. An epoch's permutation is affine, position i to
(a·i + c) mod n with a prime to n and a, c drawn from the seed, and a
batch computes only its own rows: drawing a whole permutation of 2.45M
rows takes the host 0.1-0.15 s, which would stall the feed inside the
measured window at every epoch's start. Each batch carries a sampling seed counting up
from one drawn from the run's seed, 31 bits wide as the estimator's
training stream is. The batches of `keep` (first, count) are kept, for
the comparison with the reference.

Gate passes batches through until its deadline, then stops at the next
whole window of K batches counted from `align`, or after a number of
batches.
"""

from __future__ import annotations

import math
import time
from typing import Iterator, Optional, Tuple

import numpy as np


class RootFeed:
    def __init__(self, pool: np.ndarray, batch: int, seed: int,
                 first_sample_seed: int, keep: Tuple[int, int] = (0, 0)):
        if len(pool) < batch:
            raise ValueError(f"a pool of {len(pool)} rows holds no batch "
                             f"of {batch}")
        self.pool = np.asarray(pool, np.int32)
        self.batch = int(batch)
        self.rng = np.random.default_rng(seed)
        self.per_epoch = len(self.pool) // self.batch
        self.pos = self.per_epoch
        self.sample_seed = int(first_sample_seed) & 0x7FFFFFFF
        self.keep = range(int(keep[0]), int(keep[0]) + int(keep[1]))
        self.drawn = 0
        self.kept = []

    def __iter__(self) -> Iterator[dict]:
        return self

    def _new_epoch(self) -> None:
        n = len(self.pool)
        while True:
            a = int(self.rng.integers(1, max(n, 2)))
            if math.gcd(a, n) == 1:
                break
        self.a, self.c = a, int(self.rng.integers(0, n))
        self.pos = 0

    def __next__(self) -> dict:
        if self.pos == self.per_epoch:
            self._new_epoch()
        i = np.arange(self.pos * self.batch, (self.pos + 1) * self.batch,
                      dtype=np.int64)
        roots = self.pool[(self.a * i + self.c) % len(self.pool)]
        self.pos += 1
        self.sample_seed = (self.sample_seed + 1) & 0x7FFFFFFF
        b = {"roots": roots, "sample_seed": self.sample_seed}
        if self.drawn in self.keep:
            self.kept.append({"roots": roots.copy(),
                              "sample_seed": self.sample_seed})
        self.drawn += 1
        return b


class Gate:
    def __init__(self, source: Iterator[dict], steps_per_loop: int):
        self.source = source
        self.k = int(steps_per_loop)
        self.count = 0
        self.align = 0
        self.deadline = math.inf
        self.limit: Optional[int] = None

    def open(self, align: int, deadline: float = math.inf,
             limit: Optional[int] = None) -> None:
        """From batch `align` on, stop at the first whole window past
        `deadline` (time.monotonic()) or after `limit` batches."""
        self.align, self.deadline, self.limit = int(align), deadline, limit

    def __iter__(self):
        return self

    def __next__(self):
        k = self.count - self.align
        if k >= 0 and k % self.k == 0:
            if time.monotonic() >= self.deadline or (
                    self.limit is not None and k >= self.limit):
                raise StopIteration
        self.count += 1
        return next(self.source)
