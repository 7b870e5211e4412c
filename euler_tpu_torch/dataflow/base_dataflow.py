"""Mini-batch fanout builders over the graph engine (copy of
euler_tpu/dataflow/base_dataflow.py:41-91, `DataFlow` and
`FanoutDataFlow`).

A dataflow is a host-side callable roots → batch dict of fixed-shape
numpy arrays: hop h holds exactly n_roots·Πk_{≤h} ids (the engine pads
its draws with default_id), so every step has the same shapes. Nothing
here is torch; the estimator moves the batch to the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
