"""Mini-batch builders over the graph engine (copy of
euler_tpu/dataflow/base_dataflow.py:41-285: `DataFlow`,
`FanoutDataFlow`, `WholeDataFlow`, `FullBatchDataFlow`,
`LayerwiseDataFlow` and `FastGCNDataFlow`; RelationDataFlow is not
ported yet, ROADMAP.md Queue A, 'GNN library breadth').

A dataflow is a host-side callable roots → batch dict of numpy arrays.
Three geometries, as the reference's:
  * fanout batches: hop h holds exactly n_roots·Πk_{≤h} ids (the
    engine pads its draws with default_id), the same shapes every step;
  * edge_index batches: a node table and its [2, E] edges for the conv
    stacks (a closure of the roots, or the whole graph, built once);
  * layerwise batches: per-layer pools and the dense adjacency between
    levels (FastGCN/LADIES).
Nothing here is torch; the estimator moves the batch to the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from euler_tpu_torch.graph import GraphEngine


class DataFlow:
    """Base: fetches features for id tensors; subclasses build topology."""

    def __init__(self, graph: GraphEngine, feature_ids: Sequence = (),
                 feature_dims: Optional[Sequence[int]] = None,
                 default_id: int = 0):
        self.graph = graph
        self.feature_ids = list(feature_ids)
        self.feature_dims = list(feature_dims) if feature_dims else None
        self.default_id = default_id

    def features(self, ids: np.ndarray) -> np.ndarray:
        """Concatenated dense features [n, sum(dims)] for ids."""
        if not self.feature_ids:
            raise ValueError("dataflow has no feature_ids configured")
        feats = self.graph.get_dense_feature(ids, self.feature_ids,
                                             self.feature_dims)
        if isinstance(feats, list):
            return np.concatenate(feats, axis=1)
        return feats

    def __call__(self, roots: np.ndarray) -> Dict:
        raise NotImplementedError


class FanoutDataFlow(DataFlow):
    """Multi-hop fanout batches (the reference's SageDataFlow /
    NeighborDataFlow).

    Batch dict:
      ids:    list of L+1 uint64 arrays, ids[0] = roots
      layers: list of L+1 float32 feature arrays (if feature_ids set)
      weights/types: per-hop sample metadata (optional use)
    """

    def __init__(self, graph, fanouts: Sequence[int], edge_types=None,
                 with_features: bool = True, **kw):
        super().__init__(graph, **kw)
        self.fanouts = list(fanouts)
        self.edge_types = edge_types
        self.with_features = with_features

    def __call__(self, roots: np.ndarray) -> Dict:
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        ids, w, t = self.graph.sample_fanout(
            roots, self.fanouts, edge_types=self.edge_types,
            default_id=self.default_id)
        all_ids = [roots] + ids
        batch = {"ids": all_ids, "weights": w, "types": t}
        if self.with_features and self.feature_ids:
            batch["layers"] = [self.features(i) for i in all_ids]
        return batch


class WholeDataFlow(DataFlow):
    """The roots' full `hops`-hop closure as an edge_index batch (the
    reference's WholeDataFlow): the batch nodes and all their
    neighbors, deduplicated, with local edge rows. Shapes vary with the
    closure; pad_to_multiple rounds the node table and the edges up
    (pad rows default_id, pad edges on the last row)."""

    def __init__(self, graph, edge_types=None, hops: int = 1,
                 pad_to_multiple: int = 256, **kw):
        super().__init__(graph, **kw)
        self.edge_types = edge_types
        self.hops = hops
        self.pad = pad_to_multiple

    def __call__(self, roots: np.ndarray) -> Dict:
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        frontier = roots
        nodes = [roots]
        edges_src: List[np.ndarray] = []
        edges_dst: List[np.ndarray] = []
        for _ in range(self.hops):
            off, nbr, w, t = self.graph.get_full_neighbor(
                frontier, edge_types=self.edge_types)
            counts = np.diff(off).astype(np.int64)
            e_dst = np.repeat(frontier, counts)
            edges_src.append(nbr)
            edges_dst.append(e_dst)
            frontier = np.unique(nbr)
            nodes.append(frontier)
        node_table = np.unique(np.concatenate(nodes))
        # np.unique returns sorted ids → local rows via binary search
        empty = np.zeros(0, np.uint64)
        src = np.concatenate(edges_src) if edges_src else empty
        dst = np.concatenate(edges_dst) if edges_dst else empty
        src_idx = np.searchsorted(node_table, src).astype(np.int32)
        dst_idx = np.searchsorted(node_table, dst).astype(np.int32)
        root_idx = np.searchsorted(node_table, roots).astype(np.int32)
        n_real = len(node_table)
        # pad table and edges to bucket boundaries for bounded recompiles
        n_pad = -len(node_table) % self.pad
        e_pad = -len(src_idx) % self.pad
        node_table = np.concatenate(
            [node_table, np.full(n_pad, self.default_id, np.uint64)])
        pad_row = len(node_table) - 1 if n_pad else 0
        src_idx = np.concatenate([src_idx, np.full(e_pad, pad_row, np.int32)])
        dst_idx = np.concatenate([dst_idx, np.full(e_pad, pad_row, np.int32)])
        batch = {
            "nodes": node_table,
            "edge_index": np.stack([src_idx, dst_idx]).astype(np.int32),
            "root_index": root_idx,
            "n_real_nodes": n_real,
            "n_real_edges": len(src),
        }
        if self.feature_ids:
            batch["x"] = self.features(node_table)
        return batch


class FullBatchDataFlow(DataFlow):
    """Whole-graph batches (the reference's FullBatchDataFlow, Cora-scale
    transductive training): the node table, edge_index, edge weights and
    types and the features are the whole graph, built once; a step's
    batch adds its root_index. Every step's batch holds the whole
    static part, and the estimator copies it to the device each step,
    as the reference's does."""

    def __init__(self, graph, edge_types=None, **kw):
        super().__init__(graph, **kw)
        self.edge_types = edge_types
        self._static: Optional[Dict] = None

    def _build_static(self) -> Dict:
        nodes = np.sort(self.graph.all_node_ids())
        off, nbr, w, t = self.graph.get_full_neighbor(
            nodes, edge_types=self.edge_types)
        counts = np.diff(off).astype(np.int64)
        src_ids = nbr
        dst_ids = np.repeat(nodes, counts)
        src_idx = np.searchsorted(nodes, src_ids).astype(np.int32)
        dst_idx = np.searchsorted(nodes, dst_ids).astype(np.int32)
        static = {
            "nodes": nodes,
            "edge_index": np.stack([src_idx, dst_idx]),
            "edge_weight": w.astype(np.float32),
            "edge_type": t.astype(np.int32),
        }
        if self.feature_ids:
            static["x"] = self.features(nodes)
        return static

    def __call__(self, roots: np.ndarray) -> Dict:
        if self._static is None:
            self._static = self._build_static()
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        batch = dict(self._static)
        batch["root_index"] = np.searchsorted(
            self._static["nodes"], roots).astype(np.int32)
        return batch


class LayerwiseDataFlow(DataFlow):
    """LADIES-style layerwise batches (the reference's
    LayerwiseDataFlow): per-layer pools drawn by the engine's
    sample_layerwise, each level the previous one and its pool, and the
    dense adjacency between levels. sample=False expands the exact
    1-hop closure of each level instead (FastGCN's evaluation: train on
    sampled pools, evaluate with the full propagation matrix)."""

    def __init__(self, graph, layer_sizes: Sequence[int], edge_types=None,
                 sample: bool = True, **kw):
        super().__init__(graph, **kw)
        self.layer_sizes = list(layer_sizes)
        self.edge_types = edge_types
        self.sample = sample

    def _dense_adj(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Row-normalized dense adjacency [len(rows), len(cols)] of
        Â = A + I restricted to the pool. Each (edge, matching column)
        pair is expanded through searchsorted ranges over the sorted
        columns: a duplicate pool column receives the edge weight once
        per copy, and a later parallel edge overwrites an earlier one."""
        rows = np.asarray(rows, np.uint64)
        cols_arr = np.asarray(cols, np.uint64)
        order = np.argsort(cols_arr, kind="stable")
        sc = cols_arr[order]
        adj = np.zeros((len(rows), len(cols_arr)), dtype=np.float32)
        off, nbr, w, _ = self.graph.get_full_neighbor(
            rows, edge_types=self.edge_types)

        def expand(ids, per_id_row):
            """(row, col, run-length) triples for every position of
            each id in the sorted col array."""
            lo = np.searchsorted(sc, ids)
            hi = np.searchsorted(sc, ids, side="right")
            cnt = (hi - lo).astype(np.int64)
            total = int(cnt.sum())
            if total == 0:
                return (np.empty(0, np.int64), np.empty(0, np.int64),
                        np.empty(0, np.int64))
            rep = np.repeat(np.arange(len(ids)), cnt)
            pos_in_run = np.arange(total) - np.repeat(
                np.cumsum(cnt) - cnt, cnt)
            cpos = order[np.repeat(lo, cnt) + pos_in_run]
            return per_id_row[rep], cpos, rep

        edge_row = np.repeat(np.arange(len(rows)),
                             np.diff(off).astype(np.int64))
        er, ec, eidx = expand(nbr, edge_row)
        adj[er, ec] = w[eidx]
        sr, scol, _ = expand(rows, np.arange(len(rows)))
        # (row, col) pairs cannot repeat here (one sorted run per row),
        # so a plain fancy += is exact
        adj[sr, scol] += 1.0
        norm = adj.sum(axis=1, keepdims=True)
        return adj / np.maximum(norm, 1e-12)

    def __call__(self, roots: np.ndarray) -> Dict:
        roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
        levels = [roots]
        if self.sample:
            pools = self.graph.sample_layerwise(
                roots, self.layer_sizes, edge_types=self.edge_types,
                default_id=self.default_id)
            # each level holds the previous one (LADIES' connectivity
            # guarantee), so a self-loop always has a column
            for p in pools:
                levels.append(np.concatenate([levels[-1], p]))
        else:
            for _ in self.layer_sizes:
                _, nbr, _, _ = self.graph.get_full_neighbor(
                    levels[-1], edge_types=self.edge_types)
                levels.append(np.unique(np.concatenate([levels[-1], nbr])))
        adjs = [self._dense_adj(levels[i], levels[i + 1])
                for i in range(len(levels) - 1)]
        batch = {"ids": levels, "adjs": adjs}
        if self.feature_ids:
            batch["layers"] = [self.features(i) for i in levels]
        return batch


class FastGCNDataFlow(LayerwiseDataFlow):
    """FastGCN: layerwise sampling with independent pools per layer; the
    engine's layerwise sampler already draws each layer by importance,
    so it is LayerwiseDataFlow."""
