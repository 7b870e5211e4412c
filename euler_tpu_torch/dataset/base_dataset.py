"""Datasets as engine graphs (counterpart of
euler_tpu/dataset/base_dataset.py: `GraphData`, `build_engine` and the
file loaders `_csr_to_dense`, `_csr_to_edges`, `_load_npz`,
`_load_ogb_dir` and `load_named`, copies of :42-83 and :163-296).

`build_engine` is a copy of the reference's: node i is id i, its split
is its node type (TRAIN 0, VAL 1, TEST 2), its features the dense
feature "feature" (fid 0) and its label, one-hot, the dense feature
"label" (fid 1); an undirected edge is stored in both directions. The
engine drops duplicate (src, dst) pairs and keeps each node's neighbors
sorted. `engine_from_arrays` feeds it the port's stand-in arrays
(synthetic.GraphArrays), whose CSR already holds both directions
without duplicates, as directed edges: the engine then holds the same
edge set the reference's holds for the same draws.

`load_named(name, cfg)` resolves a named dataset in the reference's
order:
  1. a prepared engine directory $EULER_TPU_DATA_DIR/<name>/ (meta.bin,
     part_*.dat: GraphEngine.dump's or tools/generate_data.py's);
  2. $EULER_TPU_DATA_DIR/<name>.npz, native keys (features, labels,
     edges, optional train/val/test masks) or the gnn-benchmark CSR
     layout (adj_*/attr_*/labels); absent masks get the planetoid split;
  3. an OGB-style directory $EULER_TPU_DATA_DIR/<name>/ of edge_index,
     node_feat, node_label and {train,valid,test}_idx .npy files;
  4. the synthetic stand-in of the dataset's shape (cfg).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

from euler_tpu_torch.dataset.synthetic import (
    TEST_TYPE, TRAIN_TYPE, VAL_TYPE, GraphArrays, synthetic_citation,
)
from euler_tpu_torch.dataset.synthetic import (
    planetoid_split as _planetoid_split,
)
from euler_tpu_torch.graph import GraphBuilder, GraphEngine

DATA_DIR_ENV = "EULER_TPU_DATA_DIR"

FEATURE_FID = 0   # 'feature'
LABEL_FID = 1     # 'label'


@dataclass
class GraphData:
    """A loaded node-classification dataset."""

    engine: GraphEngine
    num_classes: int
    feature_dim: int
    max_id: int
    name: str = ""
    multilabel: bool = False
    source: str = "synthetic"


def build_engine(features: np.ndarray, labels: np.ndarray,
                 edges: np.ndarray, train_mask, val_mask, test_mask,
                 directed: bool = False) -> GraphEngine:
    """Arrays → GraphEngine with the split/type/feature conventions above
    (copy of the reference's build_engine)."""
    n, d = features.shape
    if labels.ndim == 1:
        num_classes = int(labels.max()) + 1
        onehot = np.zeros((n, num_classes), np.float32)
        onehot[np.arange(n), labels.astype(int)] = 1.0
        label_mat = onehot
    else:
        label_mat = labels.astype(np.float32)
        num_classes = labels.shape[1]
    types = np.full(n, TEST_TYPE, np.int32)
    types[np.asarray(val_mask, bool)] = VAL_TYPE
    types[np.asarray(train_mask, bool)] = TRAIN_TYPE
    ids = np.arange(n, dtype=np.uint64)
    b = GraphBuilder()
    b.set_num_types(3, 1)
    b.set_feature(FEATURE_FID, 0, d, "feature")
    b.set_feature(LABEL_FID, 0, num_classes, "label")
    b.add_nodes(ids, types=types, weights=np.ones(n, np.float32))
    src = edges[0].astype(np.uint64)
    dst = edges[1].astype(np.uint64)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    b.add_edges(src, dst)
    b.set_node_dense(ids, FEATURE_FID, features.astype(np.float32))
    b.set_node_dense(ids, LABEL_FID, label_mat)
    return b.finalize()


def engine_from_arrays(g: GraphArrays, name: str = "") -> GraphData:
    """The stand-in's arrays in an engine graph, as the reference's
    synthetic_citation loads its draws (its edges are the CSR's, both
    directions already there)."""
    src = np.repeat(np.arange(g.num_nodes, dtype=np.uint64),
                    np.diff(g.offsets))
    edges = np.stack([src, g.neighbors.astype(np.uint64)])
    del src
    engine = build_engine(g.features, g.labels, edges, g.train_mask,
                          g.val_mask, g.test_mask, directed=True)
    return GraphData(engine, g.num_classes, int(g.features.shape[1]),
                     g.num_nodes - 1, name=name, source="synthetic")


def _csr_to_dense(z, prefix: str) -> np.ndarray:
    """Rebuild a dense [N, D] float32 matrix from the CSR triplet keys
    `<prefix>_data/_indices/_indptr/_shape` (the gnn-benchmark layout)
    without scipy."""
    data = z[f"{prefix}_data"]
    indices = z[f"{prefix}_indices"].astype(np.int64)
    indptr = z[f"{prefix}_indptr"].astype(np.int64)
    shape = tuple(int(s) for s in z[f"{prefix}_shape"])
    out = np.zeros(shape, np.float32)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    out[rows, indices] = data
    return out


def _csr_to_edges(z, prefix: str = "adj") -> np.ndarray:
    indices = z[f"{prefix}_indices"].astype(np.int64)
    indptr = z[f"{prefix}_indptr"].astype(np.int64)
    n = int(z[f"{prefix}_shape"][0])
    src = np.repeat(np.arange(n), np.diff(indptr))
    return np.stack([src, indices])


def _load_npz(path: str, name: str) -> GraphData:
    """A `.npz` under $EULER_TPU_DATA_DIR/<name>.npz in one of two
    layouts: native (features [N,D], labels [N] or [N,C], edges [2,E],
    train_mask/val_mask/test_mask [N] bool, all three masks or none) or
    the gnn-benchmark CSR (adj_data/adj_indices/adj_indptr/adj_shape +
    attr_data/attr_indices/attr_indptr/attr_shape + labels). Absent
    masks get the planetoid split; multilabel data needs masks."""
    z = np.load(path, allow_pickle=False)
    keys = set(z.files)

    def masks_for(labels):
        have = {"train_mask", "val_mask", "test_mask"} & keys
        if len(have) == 3:
            return z["train_mask"], z["val_mask"], z["test_mask"]
        if have:
            raise ValueError(
                f"{path}: carries {sorted(have)} but not all of "
                "train_mask/val_mask/test_mask — provide all three or "
                "none (absent masks get the planetoid split; see DATA.md)")
        if labels.ndim > 1:
            raise ValueError(
                f"{path}: multilabel [N, C] labels need explicit "
                "train/val/test masks — the planetoid per-class split "
                "protocol is single-label only (see DATA.md)")
        return _planetoid_split(labels)

    if {"features", "labels", "edges"} <= keys:
        features, labels, edges = z["features"], z["labels"], z["edges"]
        masks = masks_for(labels)
    elif {"adj_data", "adj_indices", "adj_indptr", "adj_shape",
          "labels"} <= keys:
        features = _csr_to_dense(z, "attr")
        labels = z["labels"]
        edges = _csr_to_edges(z, "adj")
        masks = masks_for(labels)
    else:
        raise ValueError(
            f"{path}: unrecognized npz layout (keys: {sorted(keys)}); "
            "expected native keys (features/labels/edges/*_mask) or the "
            "gnn-benchmark CSR keys (adj_*/attr_*/labels) — see DATA.md")
    engine = build_engine(features, labels, edges, *masks)
    num_classes = int(labels.max()) + 1 if labels.ndim == 1 else labels.shape[1]
    return GraphData(engine, num_classes, features.shape[1],
                     int(features.shape[0]) - 1, name=name,
                     multilabel=labels.ndim > 1, source=path)


def _load_ogb_dir(path: str, name: str) -> GraphData:
    """An OGB-style directory $EULER_TPU_DATA_DIR/<name>/: edge_index.npy
    [2,E], node_feat.npy [N,D], node_label.npy [N] or [N,1], and
    train_idx.npy/valid_idx.npy/test_idx.npy."""
    ld = {k: np.load(os.path.join(path, f"{k}.npy"))
          for k in ("edge_index", "node_feat", "node_label",
                    "train_idx", "valid_idx", "test_idx")}
    labels = ld["node_label"].reshape(-1).astype(np.int64)
    n = ld["node_feat"].shape[0]
    masks = []
    for k in ("train_idx", "valid_idx", "test_idx"):
        m = np.zeros(n, bool)
        m[ld[k].reshape(-1).astype(np.int64)] = True
        masks.append(m)
    engine = build_engine(ld["node_feat"], labels, ld["edge_index"], *masks)
    return GraphData(engine, int(labels.max()) + 1, ld["node_feat"].shape[1],
                     n - 1, name=name, source=path)


def load_named(name: str, synthetic_cfg: Dict) -> GraphData:
    """The named dataset from $EULER_TPU_DATA_DIR's files, in the order
    of the module docstring, else its stand-in drawn from synthetic_cfg
    (synthetic.synthetic_citation's arguments)."""
    data_dir = os.environ.get(DATA_DIR_ENV, "")
    if data_dir:
        bin_dir = os.path.join(data_dir, name)
        if os.path.exists(os.path.join(bin_dir, "meta.bin")):
            eng = GraphEngine.load(bin_dir)
            d = eng.feature_dim("feature")
            c = eng.feature_dim("label")
            n = eng.node_count
            return GraphData(eng, c, d, n - 1, name=name, source=bin_dir)
        npz = os.path.join(data_dir, f"{name}.npz")
        if os.path.exists(npz):
            return _load_npz(npz, name)
        if os.path.exists(os.path.join(bin_dir, "edge_index.npy")):
            return _load_ogb_dir(bin_dir, name)
    return engine_from_arrays(synthetic_citation(**synthetic_cfg), name=name)
