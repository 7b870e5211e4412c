"""Synthetic node-classification graphs as arrays (counterpart of the
numpy half of euler_tpu/dataset/base_dataset.py:54-160).

The reference feeds these arrays into its native graph engine
(build_engine), which stores an undirected edge in both directions,
drops duplicate (src, dst) pairs and keeps each node's neighbors sorted.
`to_csr` applies the same rules and returns the adjacency as CSR, which
DeviceNeighborTable.from_csr reads and base_dataset.engine_from_arrays
loads into the port's engine. The numpy draws are the reference's, in
the same order, so the same seed gives the same features, labels and
edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# split as node type (reference: base_dataset.py TRAIN/VAL/TEST_TYPE)
TRAIN_TYPE, VAL_TYPE, TEST_TYPE = 0, 1, 2


@dataclass
class GraphArrays:
    """A node-classification graph: node i is id i and table row i.
    offsets [N+1] int64 / neighbors [E] int32 are the CSR adjacency;
    labels [N] int64; masks [N] bool (the planetoid split)."""

    features: np.ndarray
    labels: np.ndarray
    num_classes: int
    offsets: np.ndarray
    neighbors: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def node_types(self) -> np.ndarray:
        """[N] int32 split per node, as the reference's build_engine
        (base_dataset.py:54-83) types them: TRAIN where train_mask,
        else VAL where val_mask, else TEST — every node outside the
        train and val splits is TEST_TYPE, in test_mask or not."""
        types = np.full(self.num_nodes, TEST_TYPE, np.int32)
        types[self.val_mask] = VAL_TYPE
        types[self.train_mask] = TRAIN_TYPE
        return types

    def onehot_labels(self) -> np.ndarray:
        out = np.zeros((self.num_nodes, self.num_classes), np.float32)
        out[np.arange(self.num_nodes), self.labels] = 1.0
        return out


def to_csr(n: int, edges: np.ndarray, directed: bool = False):
    """[2, E] (src, dst) pairs → CSR (offsets [n+1] int64, neighbors
    int32): both directions unless directed, duplicates dropped,
    neighbors of each node ascending."""
    src = edges[0].astype(np.int64)
    dst = edges[1].astype(np.int64)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    # sort + drop adjacent repeats: np.unique's speed on 10^8 keys
    # varies several-fold across numpy versions, an in-place sort does not
    key = src * n + dst
    del src, dst
    key.sort()
    keep = np.ones(key.size, bool)
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    src, dst = np.divmod(key[keep], n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=offsets[1:])
    return offsets, dst.astype(np.int32)


def planetoid_split(labels_1d: np.ndarray, train_per_class: int = 20,
                    val: int = 500, test: int = 1000):
    """The planetoid split over nodes in id order (reference:
    base_dataset.py:_planetoid_split)."""
    n = labels_1d.shape[0]
    train_mask = np.zeros(n, bool)
    for c in np.unique(labels_1d):
        train_mask[np.where(labels_1d == c)[0][:train_per_class]] = True
    rest = np.where(~train_mask)[0]
    val_mask = np.zeros(n, bool)
    val_mask[rest[:val]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[val:val + test]] = True
    return train_mask, val_mask, test_mask


def synthetic_citation(n: int, d: int, num_classes: int,
                       intra_degree: float = 4.0, inter_degree: float = 1.0,
                       signal: float = 1.6, seed: int = 0,
                       train_per_class: int = 20, val: int = 500,
                       test: int = 1000, informative_dims: int = 0,
                       confuse_frac: float = 0.0) -> GraphArrays:
    """SBM graph + class-informative features (reference:
    base_dataset.py:synthetic_citation, which documents the knobs)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    feat_class = labels.copy()
    if confuse_frac > 0:
        flip = rng.random(n) < confuse_frac
        shift = rng.integers(1, num_classes, n)
        feat_class = np.where(flip, (labels + shift) % num_classes, labels)
    if informative_dims and informative_dims < d:
        k = int(informative_dims)
        class_dims = np.stack(
            [rng.choice(d, size=k, replace=False)
             for _ in range(num_classes)])
        per_dim_gain = rng.uniform(0.5, 1.5, (num_classes, k))
        features = rng.normal(0, 1.0, (n, d))
        bump = signal * per_dim_gain[feat_class]
        np.add.at(features, (np.arange(n)[:, None], class_dims[feat_class]),
                  bump)
        features = features.astype(np.float32)
    else:
        centers = rng.normal(0, 1.0, (num_classes, d))
        features = (signal * centers[feat_class]
                    + rng.normal(0, 1.0, (n, d))).astype(np.float32)
    n_intra = int(n * intra_degree / 2)
    n_inter = int(n * inter_degree / 2)
    by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    class_sizes = np.array([len(b) for b in by_class], np.int64)
    class_offs = np.concatenate([[0], np.cumsum(class_sizes)])
    nodes_by_class = np.concatenate(by_class) if n else np.array([], np.int64)
    intra_src = rng.integers(0, n, n_intra)
    src_cls = labels[intra_src]
    within = rng.integers(0, class_sizes[src_cls])
    intra_dst = nodes_by_class[class_offs[src_cls] + within]
    inter_src = rng.integers(0, n, n_inter)
    inter_dst = rng.integers(0, n, n_inter)
    edges = np.stack([
        np.concatenate([intra_src, inter_src]),
        np.concatenate([intra_dst, inter_dst]),
    ])
    train_mask, val_mask, test_mask = planetoid_split(
        labels, train_per_class=train_per_class, val=val, test=test)
    offsets, neighbors = to_csr(n, edges)
    return GraphArrays(features, labels.astype(np.int64), num_classes,
                       offsets, neighbors, train_mask, val_mask, test_mask)


def products_like(n_nodes: int, avg_degree: int, feat_dim: int,
                  num_classes: int, seed: int = 0) -> GraphArrays:
    """ogbn-products-shaped synthetic graph, as bench.py's
    build_products_like draws it (bench.py:96-108)."""
    return synthetic_citation(
        n=n_nodes, d=feat_dim, num_classes=num_classes,
        intra_degree=avg_degree * 0.75, inter_degree=avg_degree * 0.25,
        signal=1.0, seed=seed,
        train_per_class=max(20, n_nodes // (num_classes * 10)),
        val=n_nodes // 20, test=n_nodes // 10)
