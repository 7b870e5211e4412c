"""NodeEstimator on device-resident tables (counterpart of
euler_tpu/estimator/estimators.py:19-253, its feature_store +
device_sampler branch).

A batch is root rows plus a sample seed; the model draws the fanout and
gathers features and labels on the device. Seeds come in two streams,
seed = stream<<31 | counter: stream 0 for training, stream 1 for
evaluation and inference, so how often one evaluates never shifts the
training draws. The stream-1 counter and the padded, masked sweeps
(eval_sweep_input_fn, infer_input_fn) are NodeInferencer's.

The reference draws roots with GraphEngine.sample_node, uniformly over
a split's unit-weight nodes. The port has no graph engine yet
(ROADMAP.md Queue A, 'Engine binding'): the split is a node_types array
aligned with the feature store's ids, and roots are drawn uniformly,
with replacement, by a numpy Generator per stream seeded from
(params["seed"], stream). The host-fed dataflow path needs the engine
and is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from euler_tpu_torch.estimator.base_estimator import (
    _ROADMAP_ENGINE, BaseEstimator,
)
from euler_tpu_torch.estimator.infer import NodeInferencer
from euler_tpu_torch.platform import DeviceLike

_TRAIN_STREAM, _EVAL_STREAM = 0, 1


class NodeEstimator(BaseEstimator):
    """Supervised node classification with on-device sampling.

    node_types: [N] int split per node (dataset TRAIN/VAL/TEST types),
    in the order of feature_store.ids. params: batch_size (32),
    train_node_type (0), eval_node_type (1), infer_node_type (-1 = all
    nodes), and BaseEstimator's keys."""

    def __init__(self, model, params: Dict[str, Any], node_types,
                 feature_store, device_sampler,
                 model_dir: Optional[str] = None, device: DeviceLike = None):
        if feature_store is None or device_sampler is None:
            raise NotImplementedError(
                "host-fed batches (a dataflow over the graph engine) are "
                f"not ported yet: {_ROADMAP_ENGINE}; pass a feature_store "
                "and a device_sampler")
        if feature_store.labels is None:
            raise NotImplementedError(
                "labels fetched from the graph engine are not ported yet: "
                f"{_ROADMAP_ENGINE}; build the feature store with labels")
        super().__init__(model, params, model_dir, device)
        for what, t in (("feature store", feature_store),
                        ("neighbor table", device_sampler)):
            if t.device != self.device:
                raise ValueError(f"{what} is on {t.device}, the estimator "
                                 f"on {self.device}")
        self.node_types = np.asarray(node_types).ravel()
        if self.node_types.shape[0] != len(feature_store.ids):
            raise ValueError(f"{self.node_types.shape[0]} node types for "
                             f"{len(feature_store.ids)} nodes")
        self.feature_store = feature_store
        self.batch_size = int(self.params_cfg.get("batch_size", 32))
        self.train_node_type = int(self.params_cfg.get("train_node_type", 0))
        self.eval_node_type = int(self.params_cfg.get("eval_node_type", 1))
        self.infer_node_type = int(self.params_cfg.get("infer_node_type", -1))
        self.inferencer = NodeInferencer(self.model, feature_store,
                                         device_sampler, self.batch_size)
        self.static_batch = self.inferencer.static_batch
        self._train_seed_counter = 0
        self._root_rngs = {s: np.random.default_rng([self.seed, s])
                           for s in (_TRAIN_STREAM, _EVAL_STREAM)}
        self._split_cache: Dict[int, np.ndarray] = {}

    def split_ids(self, node_type: int) -> np.ndarray:
        """All node ids of a split (node type; -1 = every node), in
        store order."""
        if node_type < 0:
            return self.feature_store.ids
        ids = self._split_cache.get(node_type)
        if ids is None:
            ids = self.feature_store.ids[self.node_types == node_type]
            self._split_cache[node_type] = ids
        return ids

    def _next_seed(self, stream: int) -> int:
        if stream == _EVAL_STREAM:
            return self.inferencer._next_seed()
        self._train_seed_counter += 1
        return (_TRAIN_STREAM << 31) | self._train_seed_counter

    def _batches(self, node_type: int, stream: int) -> Iterator[Dict]:
        ids = self.split_ids(node_type)
        if len(ids) == 0:
            raise ValueError(f"node type {node_type} has no nodes")
        rng = self._root_rngs[stream]
        while True:
            roots = ids[rng.integers(0, len(ids), self.batch_size)]
            yield self.inferencer.batch(roots, self._next_seed(stream))

    def train_input_fn(self) -> Iterator[Dict]:
        return self._batches(self.train_node_type, _TRAIN_STREAM)

    def eval_input_fn(self) -> Iterator[Dict]:
        return self._batches(self.eval_node_type, _EVAL_STREAM)

    def eval_sweep_steps(self, node_type: Optional[int] = None) -> int:
        n = len(self.split_ids(
            self.eval_node_type if node_type is None else node_type))
        return max((n + self.batch_size - 1) // self.batch_size, 1)

    def eval_sweep_input_fn(self, node_type: Optional[int] = None
                            ) -> Iterator[Dict]:
        """Every node of a split exactly once; the final batch is padded
        with a metric_mask zeroing the pad rows."""
        return self.inferencer.infer_input_fn(self.split_ids(
            self.eval_node_type if node_type is None else node_type))

    def infer_input_fn(self) -> Iterator[Dict]:
        """Deterministic sweep over the infer split (padded final
        batch)."""
        return self.inferencer.infer_input_fn(
            self.split_ids(self.infer_node_type))
