"""Graph-classification datasets (mutag family): a copy of
euler_tpu/dataset/graph_sets.py (GraphSetData, mutag_like and their
helpers), which imports no JAX, kept here because the port imports
nothing of euler_tpu. tests/test_torch_graph.py pins it to the original
array for array.

The reference's stand-in for tf_euler/python/dataset/mutag.py: a
deterministic synthetic set of two structural classes of small
molecule-like graphs (cycles vs trees with decorations) that GIN-class
models separate at about 0.9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class GraphSetData:
    graphs: List[dict]          # each {x [n,D], edge_index [2,e]}
    labels: np.ndarray
    num_classes: int
    feature_dim: int
    train_indices: np.ndarray
    eval_indices: np.ndarray
    name: str = "mutag"


def _atom_features(n, rng, d):
    """Class-independent one-hot "atom types" (like MUTAG's 7 atom
    one-hots). Regular atoms draw from types 2..d-1; types 0/1 are the
    "aromatic" types assigned explicitly by _graph — identically many in
    both classes, so features alone carry ZERO label signal."""
    types = rng.integers(2, d, n)
    x = np.zeros((n, d), dtype=np.float32)
    x[np.arange(n), types] = 1.0
    return x


def _tree_edges(n, rng):
    parents = np.array([rng.integers(0, max(i, 1)) for i in range(1, n)])
    child = np.arange(1, n)
    return np.stack([parents, child])


def _graph(n, rng, d, with_ring: bool, ring_len: int, num_rings: int = 1):
    """Molecule-like graphs. Ring class: an explicit ring of `ring_len`
    aromatic atoms with tree decorations hanging off it. Tree class: pure
    random tree with the same number of aromatic atoms scattered
    non-adjacent. Detecting the aromatic RING (adjacent aromatic atoms on
    a cycle) is what message passing must learn."""
    x = _atom_features(n, rng, d)
    if with_ring:
        # nodes 0..ring_len-1 form the ring; the rest attach as random
        # tree decorations to any earlier node
        ring = np.arange(ring_len)
        ring_ei = np.stack([ring, np.roll(ring, -1)])
        deco_parents = np.array(
            [rng.integers(0, i) for i in range(ring_len, n)])
        deco = np.stack([deco_parents, np.arange(ring_len, n)])
        ei = np.concatenate([ring_ei, deco], axis=1)
        # aromatic-carbon-like skew: every ring atom becomes type 0/1
        # — ADJACENT aromatic atoms on a cycle
        aromatic = list(ring)
    else:
        ei = _tree_edges(n, rng)
        # SAME expected number of aromatic atoms, but placed as an
        # independent set (greedy, non-adjacent): the global atom
        # histogram matches the ring class, so a feature-only readout is
        # ≈ chance; only message passing sees the adjacency co-occurrence
        # (real MUTAG's aromatic-ring signal)
        k = min(n, max(1, int(rng.normal(num_rings * ring_len, 1.0))))
        nbrs = {}
        for a, b in ei.T:
            nbrs.setdefault(int(a), set()).add(int(b))
            nbrs.setdefault(int(b), set()).add(int(a))
        aromatic = []
        blocked = set()
        for v in rng.permutation(n):
            if len(aromatic) >= k:
                break
            v = int(v)
            if v in blocked:
                continue
            aromatic.append(v)
            blocked.add(v)
            blocked.update(nbrs.get(v, ()))
    for v in aromatic:
        x[v] = 0.0
        x[v, int(rng.integers(0, 2))] = 1.0
    ei = np.concatenate([ei, ei[::-1]], axis=1)
    return {"x": x, "edge_index": ei.astype(np.int32)}


def mutag_like(num_graphs: int = 188, feature_dim: int = 7,
               seed: int = 0, label_noise: float = 0.07) -> GraphSetData:
    """Calibrated difficulty (BASELINE.md: GIN 0.923, GatedGraph 0.920,
    Set2Set 0.901, GraphGCN 0.891 on real mutag): label = ring motif
    present, features are class-independent atom one-hots, and
    `label_noise` caps the Bayes accuracy near the published numbers —
    a feature-only readout scores ≈ chance (guarded by
    tests/test_tools_datasets.py)."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for i in range(num_graphs):
        n = int(rng.integers(10, 28))
        has_ring = rng.random() < 0.5
        ring_len = int(rng.integers(4, 6))
        graphs.append(_graph(n, rng, feature_dim, has_ring, ring_len,
                             num_rings=1))
        y = int(has_ring)
        if rng.random() < label_noise:
            y = 1 - y
        labels.append(y)
    labels = np.asarray(labels)
    order = rng.permutation(num_graphs)
    split = int(num_graphs * 0.8)
    return GraphSetData(graphs, labels, 2, feature_dim,
                        train_indices=order[:split],
                        eval_indices=order[split:])
