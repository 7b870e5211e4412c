"""Embedding lookups and scores on the device (counterpart of
euler_tpu/serving/server.py:80-145 `_BundleEngine` and the server's
embed/score applies, :393-492).

The embedding matrix lives on the device; ids resolve to rows on the
host against the sorted id order. Unknown ids give zero rows (embed) and
zero scores (score). The TCP server, batcher, wire format and bundle
files are not ported in this slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from euler_tpu_torch.platform import DeviceLike, resolve_device


class EmbeddingEngine:
    """ids: [N] uint64 sorted ascending, unique; embeddings: [N, D]."""

    def __init__(self, ids: np.ndarray, embeddings: np.ndarray,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        ids = np.ascontiguousarray(ids, dtype=np.uint64).ravel()
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        if emb.ndim != 2 or emb.shape[0] != ids.size:
            raise ValueError(f"embeddings {emb.shape} do not match "
                             f"{ids.size} ids")
        if ids.size > 1 and not (ids[1:] > ids[:-1]).all():
            raise ValueError("ids must be sorted ascending and unique")
        self.device = dev
        self.ids = ids
        self.dim = int(emb.shape[1])
        self.table = torch.from_numpy(emb).to(dev)

    def lookup_rows(self, qids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """(row indices int32, valid mask, n_unknown) for query ids;
        unknown ids map to row 0, masked.

        Copy of euler_tpu/serving/server.py:_BundleEngine.lookup_rows."""
        qids = np.ascontiguousarray(qids, dtype=np.uint64).ravel()
        if self.ids.size == 0:
            return (np.zeros(qids.size, np.int32),
                    np.zeros(qids.size, bool), int(qids.size))
        rows = np.searchsorted(self.ids, qids).clip(0, self.ids.size - 1)
        valid = self.ids[rows] == qids
        return rows.astype(np.int32), valid, int((~valid).sum())

    def _rows(self, rows: np.ndarray, valid: np.ndarray):
        return (torch.from_numpy(rows.astype(np.int64)).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def embed(self, ids: np.ndarray) -> np.ndarray:
        """[n, D] float32 embeddings; zero rows for unknown ids."""
        rows, valid, _ = self.lookup_rows(ids)
        if self.ids.size == 0:
            return np.zeros((rows.size, self.dim), np.float32)
        r, v = self._rows(rows, valid)
        with torch.inference_mode():
            out = torch.where(v[:, None], self.table[r], 0.0)
        return out.cpu().numpy()

    def score(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """[n] float32 dot products of src and dst embeddings; 0 where
        either id is unknown."""
        a_rows, a_ok, _ = self.lookup_rows(src)
        b_rows, b_ok, _ = self.lookup_rows(dst)
        if a_rows.size != b_rows.size:
            raise ValueError(f"score needs as many src as dst ids "
                             f"({a_rows.size} != {b_rows.size})")
        if self.ids.size == 0:
            return np.zeros(a_rows.size, np.float32)
        a, ok = self._rows(a_rows, a_ok & b_ok)
        b, _ = self._rows(b_rows, b_ok)
        with torch.inference_mode():
            dots = (self.table[a] * self.table[b]).sum(-1)
            out = torch.where(ok, dots, 0.0)
        return out.cpu().numpy()
