"""Datasets as engine graphs (counterpart of
euler_tpu/dataset/base_dataset.py:42-83, `GraphData` and `build_engine`).

`build_engine` is a copy of the reference's: node i is id i, its split
is its node type (TRAIN 0, VAL 1, TEST 2), its features the dense
feature "feature" (fid 0) and its label, one-hot, the dense feature
"label" (fid 1); an undirected edge is stored in both directions. The
engine drops duplicate (src, dst) pairs and keeps each node's neighbors
sorted. `engine_from_arrays` feeds it the port's stand-in arrays
(synthetic.GraphArrays), whose CSR already holds both directions
without duplicates, as directed edges: the engine then holds the same
edge set the reference's holds for the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from euler_tpu_torch.dataset.synthetic import (
    TEST_TYPE, TRAIN_TYPE, VAL_TYPE, GraphArrays,
)
from euler_tpu_torch.graph import GraphBuilder, GraphEngine

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
