"""The version-scoped serving engine (counterpart of
euler_tpu/serving/server.py:80-146 `_BundleEngine` and the server's
embed/score applies, :393-492).

One loaded bundle (shard): its sorted ids and host embedding matrix,
the [N, D] float32 table on the server's device, a lazily built IVF
index, and the bundle's version. Gather and score are torch ops on that
table (the reference computes them in XLA, outside any Pallas kernel);
kNN stays in host numpy (tools/knn.py), as in the reference. An
InferenceServer builds one engine per bundle version and flips between
them (server.py).

Ids resolve to rows on the host against the sorted id order. Unknown
ids give zero rows (embed) and zero scores (score). Every padded shape
an apply sees is recorded (`padded_shapes`): behind the server's bucket
ladder it stays within the ladder, the port's counterpart of the
reference's jit cache sizes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from euler_tpu_torch.platform import DeviceLike, resolve_device
from euler_tpu_torch.serving.batcher import run_bucketed, warm_ladder
from euler_tpu_torch.serving.export import ModelBundle


class EmbeddingEngine:
    """Serving state for one bundle on one device. Immutable after
    construction except the lazily built index and the shape record.

    The table is uploaded on a side stream on a card and synchronized
    before the constructor returns, so an engine built while another
    serves (a hot-swap) never exposes a half-copied table and never
    queues its copy behind the serving stream's work."""

    def __init__(self, bundle: ModelBundle, device: DeviceLike,
                 ladder: Sequence[int]):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.bundle = bundle
        self.ids = bundle.ids                     # sorted uint64
        self.emb = bundle.embeddings              # [N, D] float32 host
        self.dim = bundle.dim
        self.shard = bundle.shard
        self.num_shards = bundle.num_shards
        self.version = bundle.version
        self.ladder = tuple(ladder)
        self._index = None
        self._index_mu = threading.Lock()
        self._shapes_mu = threading.Lock()
        self.padded_shapes: Dict[str, Set[int]] = {"gather": set(),
                                                   "score": set()}
        self.table = None
        t0 = time.perf_counter()
        if self.ids.size:
            host = torch.from_numpy(self.emb)
            if dev.type == "cuda":
                side = torch.cuda.Stream(dev)
                with torch.cuda.stream(side):
                    self.table = host.to(dev)
                side.synchronize()
            else:
                self.table = host
        self.upload_seconds = time.perf_counter() - t0

    def lookup_rows(self, qids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(row indices int32, valid mask, n_unknown) for query ids
        against this shard's sorted id order; unknown ids map to row 0,
        masked."""
        qids = np.ascontiguousarray(qids, dtype=np.uint64).ravel()
        if self.ids.size == 0:
            return (np.zeros(qids.size, np.int32),
                    np.zeros(qids.size, bool), int(qids.size))
        rows = np.searchsorted(self.ids, qids).clip(0, self.ids.size - 1)
        valid = self.ids[rows] == qids
        return rows.astype(np.int32), valid, int((~valid).sum())

    def _on_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def _seen(self, apply: str, n: int) -> None:
        with self._shapes_mu:
            self.padded_shapes[apply].add(int(n))

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """[n, D] float32 table rows, copied to a fresh host array."""
        self._seen("gather", rows.size)
        if self.table is None:
            return np.zeros((rows.size, self.dim), np.float32)
        with torch.inference_mode():
            return self.table[self._on_device(rows)].cpu().numpy()

    def score_rows(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """[n] float32 row dots table[a] · table[b] (summed in torch's
        order, not XLA's: float32 tolerance against the reference)."""
        self._seen("score", a.size)
        if self.table is None:
            return np.zeros(a.size, np.float32)
        with torch.inference_mode():
            ta, tb = self._on_device(a), self._on_device(b)
            return (self.table[ta] * self.table[tb]).sum(-1).cpu().numpy()

    def embed(self, ids: np.ndarray) -> Tuple[np.ndarray, int]:
        """([n, D] float32 embeddings, zero rows for unknown ids;
        n_unknown)."""
        rows, valid, n_unknown = self.lookup_rows(ids)
        if rows.size == 0:
            return np.zeros((0, self.dim), np.float32), 0
        out = run_bucketed(self.gather, [rows], self.ladder)
        out[~valid] = 0.0
        return out, n_unknown

    def score(self, src: np.ndarray, dst: np.ndarray
              ) -> Tuple[np.ndarray, int]:
        """([n] float32 dots of src and dst embeddings, 0 where either
        id is unknown; n_unknown over both ends)."""
        a, a_ok, a_unk = self.lookup_rows(src)
        b, b_ok, b_unk = self.lookup_rows(dst)
        if a.size != b.size:
            raise ValueError(f"score needs as many src as dst ids "
                             f"({a.size} != {b.size})")
        if a.size == 0:
            return np.zeros(0, np.float32), a_unk + b_unk
        out = run_bucketed(self.score_rows, [a, b], self.ladder)
        out[~(a_ok & b_ok)] = 0.0
        return out, a_unk + b_unk

    def warm(self) -> None:
        """Run both applies once at every ladder bucket BEFORE this engine
        takes traffic (startup and pre-swap both come through here), and
        rebuild the stored IVF clustering so the first approximate query
        after a flip doesn't pay the build."""
        warm_ladder(self.ladder, self.gather,
                    lambda rows: self.score_rows(rows, rows))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.bundle.index_state is not None:
            self.get_index()

    def get_index(self):
        with self._index_mu:
            if self._index is None:
                self._index = self.bundle.build_index()
            return self._index

    def id_range(self) -> Tuple[Optional[int], Optional[int]]:
        if self.ids.size == 0:
            return None, None
        return int(self.ids[0]), int(self.ids[-1])
