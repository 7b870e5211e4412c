"""kNN retrieval over embeddings on the host (copy of
euler_tpu/tools/knn.py:22-167: IVFFlatIndex, brute_force, _desc_keys;
the port imports nothing of euler_tpu). tests/test_torch_serving.py
pins the copy to the original, byte for byte.

The serving tier runs kNN here, in numpy, as the reference does
(euler_tpu/serving/server.py:_run_knn): one GEMM per request keeps a
request's bits independent of what else shared its flush, which is what
makes a sharded fleet's merged top-k byte-identical to brute_force over
the whole table.
"""

from __future__ import annotations

import numpy as np


class IVFFlatIndex:
    """Inverted-file index: k-means coarse centroids, exact scan inside
    the nprobe nearest lists (metric: inner product)."""

    def __init__(self, nlist: int = 64, nprobe: int = 8, iters: int = 10,
                 seed: int = 0):
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.iters = iters
        self.seed = seed
        self.centroids = None
        self.lists = None
        self.data = None
        self.ids = None

    def train_add(self, data: np.ndarray, ids: np.ndarray) -> None:
        n = data.shape[0]
        rng = np.random.default_rng(self.seed)
        k = min(self.nlist, max(1, n // 4))
        self.nlist = k
        self.nprobe = min(self.nprobe, k)
        centroids = data[rng.choice(n, k, replace=False)].copy()
        for _ in range(self.iters):
            assign = np.argmax(data @ centroids.T, axis=1)
            for c in range(k):
                members = data[assign == c]
                if len(members):
                    centroids[c] = members.mean(axis=0)
        assign = np.argmax(data @ centroids.T, axis=1)
        self.centroids = centroids
        self.lists = [np.where(assign == c)[0] for c in range(k)]
        self.data = data
        self.ids = ids

    def state_dict(self) -> dict:
        """Array-only serialization of the trained clustering (no data/
        ids payload — the serving bundle stores those once): centroids,
        the per-point list assignment, and nprobe. Rebuild against the
        same data/ids with from_state."""
        if self.centroids is None:
            raise ValueError("index not trained (call train_add first)")
        assign = np.empty(len(self.data), dtype=np.int64)
        for c, members in enumerate(self.lists):
            assign[members] = c
        return {"centroids": np.asarray(self.centroids, np.float32),
                "assign": assign,
                "nprobe": np.asarray(self.nprobe, np.int64)}

    @classmethod
    def from_state(cls, state: dict, data: np.ndarray,
                   ids: np.ndarray) -> "IVFFlatIndex":
        """Reconstruct a trained index from state_dict() output plus the
        original (data, ids) arrays — search results are identical to
        the index that produced the state."""
        centroids = np.asarray(state["centroids"], np.float32)
        assign = np.asarray(state["assign"], np.int64)
        if assign.shape[0] != data.shape[0]:
            raise ValueError(
                f"index state assigns {assign.shape[0]} points but data "
                f"has {data.shape[0]} rows")
        idx = cls(nlist=centroids.shape[0], nprobe=int(state["nprobe"]))
        idx.centroids = centroids
        idx.lists = [np.where(assign == c)[0]
                     for c in range(centroids.shape[0])]
        idx.data = np.asarray(data, np.float32)
        idx.ids = np.asarray(ids)
        return idx

    def search(self, queries: np.ndarray, k: int):
        if self.centroids is None:
            raise ValueError("index not trained (call train_add first)")
        # nprobe may have been set past nlist (or nlist shrank in
        # train_add): probing every list is the correct degenerate case
        nprobe = min(self.nprobe, len(self.lists))
        sims_c = queries @ self.centroids.T               # [Q, nlist]
        probe = np.argsort(-sims_c, axis=1)[:, :nprobe]
        out_ids = np.zeros((len(queries), k), dtype=self.ids.dtype)
        out_sims = np.full((len(queries), k), -np.inf, np.float32)
        for qi, q in enumerate(queries):
            cand = np.concatenate([self.lists[c] for c in probe[qi]]) \
                if len(probe[qi]) else np.arange(len(self.data))
            if len(cand) == 0:
                cand = np.arange(len(self.data))
            sims = self.data[cand] @ q
            top = np.argsort(-sims, kind="stable")[:k]
            take = cand[top]
            out_ids[qi, :len(take)] = self.ids[take]
            out_sims[qi, :len(take)] = sims[top]
        return out_ids, out_sims


def brute_force(data, ids, queries, k):
    """Exact top-k by inner product under the TOTAL order (-sim, row):
    ties break toward the lower row index, exactly like a stable
    descending sort. That makes the result well-defined under ties (a
    zero query vector ties every row at 0.0) and is what lets a
    sharded fleet's merged top-k be byte-identical to this reference:
    per-shard top-k under the same order, merged in shard order,
    resolves ties in exactly the same global row order.

    Implementation: fold -0.0 to +0.0 (bit order == value order for
    finite floats after that) and argpartition the float sims — the
    fast path. A row where the k-th value TIES values left outside the
    partition is ambiguous (partition picks ties arbitrarily); only
    those rows rerun under a composite uint64 (descending-sim bits |
    row) key, which encodes the total order exactly. Random float sims
    essentially never tie, so the composite pass normally touches only
    degenerate rows (zero queries). O(n + k log k) per query instead
    of a full stable sort of the corpus (measured ~8x the GEMM)."""
    sims = (queries @ data.T) + 0.0        # -0.0 -> +0.0, else unchanged
    n = sims.shape[1]
    k = min(int(k), n)
    if sims.dtype != np.float32 or n == 0 or k <= 0:
        top = np.argsort(-sims, axis=1, kind="stable")[:, :k]
        return ids[top], np.take_along_axis(sims, top, axis=1)
    if k >= n:
        top = np.argsort(_desc_keys(sims), axis=1)
    else:
        cand = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        cvals = np.take_along_axis(sims, cand, axis=1)
        ck = _desc_keys(cvals, rows=cand)
        top = np.take_along_axis(cand, np.argsort(ck, axis=1), axis=1)
        bound = cvals.min(axis=1)          # smallest selected sim
        n_eq_all = np.count_nonzero(sims == bound[:, None], axis=1)
        n_eq_sel = np.count_nonzero(cvals == bound[:, None], axis=1)
        bad = n_eq_all != n_eq_sel         # a boundary tie leaked out
        if bad.any():
            key = _desc_keys(sims[bad])
            sub = np.argpartition(key, k - 1, axis=1)[:, :k]
            sk = np.take_along_axis(key, sub, axis=1)
            top[bad] = np.take_along_axis(
                sub, np.argsort(sk, axis=1), axis=1)
    return ids[top], np.take_along_axis(sims, top, axis=1)


def _desc_keys(sims: np.ndarray, rows=None) -> np.ndarray:
    """uint64 sort keys realizing the (-sim, row) total order: monotone
    float32->uint32 bit map, inverted for descending, row index in the
    low word as the tie-break. `rows` supplies explicit row indices for
    a candidate subset (defaults to 0..n-1)."""
    bits = sims.view(np.uint32)
    asc = np.where(bits >> 31, ~bits, bits | np.uint32(0x80000000))
    if rows is None:
        rows = np.arange(sims.shape[1], dtype=np.uint64)
    return ((~asc).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(rows, dtype=np.uint64)
