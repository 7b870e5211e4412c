"""REAL (non-synthetic) datasets available without network egress (copy
of euler_tpu/dataset/real_sets.py: karate, karate_arrays, digits_knn;
tests/test_torch_data.py pins it to the original). networkx and sklearn
are imported inside the functions: without them the call raises
ImportError naming the library.

- karate: Zachary's karate club (1977) via networkx, an observed
  social network with its ground-truth factions ('club'): identity
  features, a few labeled nodes per faction.
- digits_knn: sklearn's bundled handwritten digits (1797 8x8 scans, the
  UCI optical-recognition corpus) with a cosine k-NN graph over the
  pixel features: real features and labels, derived edges.

Both go through build_engine with the split/type/feature conventions of
base_dataset; karate_arrays gives karate in the .npz schema load_named
reads.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.dataset.base_dataset import GraphData, build_engine


def karate(train_per_class: int = 2, seed: int = 0) -> GraphData:
    """Zachary's karate club: 34 nodes, 78 edges, 2 factions."""
    a = karate_arrays(train_per_class, seed)
    engine = build_engine(a["features"], a["labels"], a["edges"],
                          a["train_mask"], a["val_mask"], a["test_mask"])
    n = a["features"].shape[0]
    return GraphData(engine, 2, n, n - 1, name="karate",
                     source="real:networkx karate_club (Zachary 1977)")


def karate_arrays(train_per_class: int = 2, seed: int = 0):
    """The same real dataset as raw arrays in the .npz schema load_named
    expects — lets tests (and users) exercise the $EULER_TPU_DATA_DIR
    real-data path end to end."""
    import networkx as nx

    g = nx.karate_club_graph()
    n = g.number_of_nodes()
    labels = np.array(
        [0 if g.nodes[i]["club"] == "Mr. Hi" else 1 for i in range(n)],
        np.int64)
    edges = np.array(list(g.edges()), np.int64).T
    feats = np.eye(n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    train_mask = np.zeros(n, bool)
    for c in (0, 1):
        pool = np.where(labels == c)[0]
        train_mask[rng.choice(pool, train_per_class, replace=False)] = True
    rest = np.where(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(n, bool)
    val_mask[rest[: len(rest) // 3]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[len(rest) // 3:]] = True
    return dict(features=feats, labels=labels, edges=edges,
                train_mask=train_mask, val_mask=val_mask,
                test_mask=test_mask)


def digits_knn(k: int = 8, train_frac: float = 0.1, val_frac: float = 0.2,
               seed: int = 0) -> GraphData:
    """1797 real handwritten digits; k-NN graph over pixel features."""
    from sklearn.datasets import load_digits

    ds = load_digits()
    x = ds.data.astype(np.float32) / 16.0                  # [N, 64]
    y = ds.target.astype(np.int64)
    n = x.shape[0]
    # cosine k-NN over the real features (vectorized, N is small)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    sim = xn @ xn.T
    np.fill_diagonal(sim, -np.inf)
    nbrs = np.argpartition(-sim, k, axis=1)[:, :k]          # [N, k]
    src = np.repeat(np.arange(n), k)
    dst = nbrs.reshape(-1)
    edges = np.stack([src, dst])
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_tr = int(n * train_frac)
    n_val = int(n * val_frac)
    train_mask = np.zeros(n, bool)
    train_mask[order[:n_tr]] = True
    val_mask = np.zeros(n, bool)
    val_mask[order[n_tr:n_tr + n_val]] = True
    test_mask = np.zeros(n, bool)
    test_mask[order[n_tr + n_val:]] = True
    engine = build_engine(x, y, edges, train_mask, val_mask, test_mask)
    return GraphData(engine, 10, x.shape[1], n - 1, name="digits_knn",
                     source="real:sklearn digits (UCI) + kNN edges")
