"""NodeEstimator and EdgeEstimator (counterpart of
euler_tpu/estimator/estimators.py:19-287).

NodeEstimator draws each batch's roots with the graph engine's
sample_node over a split (node type; -1 = every node) and builds the
batch through one of three input paths, as the reference does:

- host arrays (no feature_store): the dataflow's batch, features
  included ("layers"), labels fetched from the engine;
- host-sampled rows (a feature_store, no device_sampler): the
  dataflow's sampled ids become int32 rows of the device feature table
  ("rows"; bench.py --host_sampler's path), labels from the store's
  label table or, without one, from the engine;
- the device sampler (a feature_store and a device_sampler): root rows
  and a sample seed; the model draws the fanout on the device.

Device-sampler seeds come in two streams, seed = stream<<31 | counter:
stream 0 for training, stream 1 for evaluation and inference, so how
often one evaluates never shifts the training draws. Evaluation sweeps
(eval_sweep_input_fn) and inference (infer_input_fn) visit every node
of a split once, the final batch padded with a metric_mask zeroing the
pad rows.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.platform import DeviceLike

_TRAIN_STREAM, _EVAL_STREAM = 0, 1


class NodeEstimator(BaseEstimator):
    """Supervised node classification (the reference's
    node_estimator.py:31-50).

    graph: a GraphEngine (roots, splits, host labels); dataflow: the
    host batch builder (e.g. FanoutDataFlow), unused with a
    device_sampler; eval_dataflow: the flow of evaluate and infer
    (default dataflow). label_fid / label_dim: the engine's dense label
    feature. feature_store: a DeviceFeatureStore (batches carry rows
    into its tables); device_sampler: a DeviceNeighborTable (needs the
    store). params: batch_size (32), train_node_type (0),
    eval_node_type (1), infer_node_type (-1 = all nodes), and
    BaseEstimator's keys."""

    def __init__(self, model, params: Dict[str, Any], graph, dataflow,
                 label_fid="label", label_dim: Optional[int] = None,
                 model_dir: Optional[str] = None, feature_store=None,
                 eval_dataflow=None, device_sampler=None,
                 device: DeviceLike = None):
        if device_sampler is not None and feature_store is None:
            raise ValueError("device_sampler requires a feature_store")
        super().__init__(model, params, model_dir, device)
        for what, t in (("feature store", feature_store),
                        ("neighbor table", device_sampler)):
            if t is not None and t.device != self.device:
                raise ValueError(f"{what} is on {t.device}, the estimator "
                                 f"on {self.device}")
        self.graph = graph
        self.dataflow = dataflow
        self.eval_dataflow = eval_dataflow or dataflow
        self.label_fid = label_fid
        self.label_dim = label_dim
        cfg = self.params_cfg
        self.batch_size = int(cfg.get("batch_size", 32))
        self.train_node_type = int(cfg.get("train_node_type", 0))
        self.eval_node_type = int(cfg.get("eval_node_type", 1))
        self.infer_node_type = int(cfg.get("infer_node_type", -1))
        self.feature_store = feature_store
        self.device_sampler = device_sampler
        self._seed_counters = {_TRAIN_STREAM: 0, _EVAL_STREAM: 0}
        self._split_cache: Dict[int, np.ndarray] = {}
        if feature_store is not None:
            self.static_batch["feature_table"] = feature_store.features
            if feature_store.feature_scale is not None:
                self.static_batch["feature_scale"] = \
                    feature_store.feature_scale
            if feature_store.labels is not None:
                self.static_batch["label_table"] = feature_store.labels
        if device_sampler is not None:
            self.static_batch.update(device_sampler.tables)

    def _labels(self, roots: np.ndarray) -> np.ndarray:
        return self.graph.get_dense_feature(
            roots, self.label_fid, self.label_dim if self.label_dim else None)

    def _node_batch(self, roots: np.ndarray, flow,
                    stream: int = _TRAIN_STREAM) -> Dict[str, Any]:
        """One batch for the given roots through whichever input path is
        configured (device sampler / feature store / host arrays)."""
        store = self.feature_store
        if self.device_sampler is not None:
            return self._sampler_batch(roots, stream)
        batch = flow(roots)
        if store is not None:
            # every hop's ids become rows of the device tables; the step
            # sees only int32 rows
            batch = {"rows": [store.lookup(i) for i in batch["ids"]],
                     "infer_ids": roots}
            if store.labels is None:
                batch["labels"] = self._labels(roots)
        else:
            batch["labels"] = self._labels(roots)
            batch["infer_ids"] = roots
        return batch

    def _sampler_batch(self, roots: np.ndarray,
                       stream: int = _TRAIN_STREAM) -> Dict[str, Any]:
        """Root rows and the stream's next seed; labels from the device
        table, else from the engine."""
        self._seed_counters[stream] += 1
        batch = {"rows": [self.feature_store.lookup(roots)],
                 "sample_seed": (stream << 31) | self._seed_counters[stream],
                 "infer_ids": roots}
        if self.feature_store.labels is None:
            batch["labels"] = self._labels(roots)
        return batch

    def _batches(self, node_type: int, flow=None,
                 stream: int = _TRAIN_STREAM) -> Iterator[Dict]:
        flow = flow or self.dataflow
        while True:
            roots = self.graph.sample_node(self.batch_size, node_type)
            yield self._node_batch(roots, flow, stream)

    def train_input_fn(self) -> Iterator[Dict]:
        return self._batches(self.train_node_type)

    def _train_batch_factory(self):
        """A thread-safe one-batch builder for the multi-worker feeder
        (params["feeder_workers"] > 1): each call draws its roots (from
        the calling thread's engine stream), expands them and fetches
        their labels. None with a device sampler: its per-batch seed
        stream is ordered, and parallel claims would decouple seed order
        from batch order, so the feeder serialises next()."""
        if self.device_sampler is not None:
            return None
        flow = self.dataflow

        def one_batch():
            roots = self.graph.sample_node(self.batch_size,
                                           self.train_node_type)
            return self._node_batch(roots, flow)

        return one_batch

    def eval_input_fn(self) -> Iterator[Dict]:
        return self._batches(self.eval_node_type, flow=self.eval_dataflow,
                             stream=_EVAL_STREAM)

    def split_ids(self, node_type: int) -> np.ndarray:
        """All node ids of a split (node type; -1 = every node), in
        engine order."""
        ids = self._split_cache.get(node_type)
        if ids is None:
            ids = self.graph.all_node_ids()
            if node_type >= 0:
                ids = ids[self.graph.get_node_type(ids) == node_type]
            self._split_cache[node_type] = ids
        return ids

    def eval_sweep_steps(self, node_type: Optional[int] = None) -> int:
        n = len(self.split_ids(
            self.eval_node_type if node_type is None else node_type))
        return max((n + self.batch_size - 1) // self.batch_size, 1)

    def _sweep(self, ids: np.ndarray, flow) -> Iterator[Dict]:
        """Every id once in batches of batch_size, stream 1; the final
        batch is padded with its last id and carries a metric_mask
        zeroing the pad rows."""
        bs = self.batch_size
        for i in range(0, len(ids), bs):
            chunk = ids[i:i + bs]
            n_real = len(chunk)
            if n_real < bs:
                chunk = np.concatenate(
                    [chunk, np.full(bs - n_real, chunk[-1], np.uint64)])
            batch = self._node_batch(chunk, flow, stream=_EVAL_STREAM)
            mask = np.zeros(bs, np.float32)
            mask[:n_real] = 1.0
            batch["metric_mask"] = mask
            yield batch

    def eval_sweep_input_fn(self, node_type: Optional[int] = None,
                            flow=None) -> Iterator[Dict]:
        """Every node of a split exactly once (default the eval split)."""
        return self._sweep(self.split_ids(
            self.eval_node_type if node_type is None else node_type),
            flow or self.eval_dataflow)

    def infer_input_fn(self) -> Iterator[Dict]:
        """Deterministic sweep over the infer split (padded final
        batch)."""
        return self._sweep(self.split_ids(self.infer_node_type),
                           self.eval_dataflow)


class EdgeEstimator(BaseEstimator):
    """Unsupervised link-based training (the reference's
    edge_estimator.py): positive edges sampled from the graph, negatives
    sampled over nodes. params: batch_size (32), num_negs (5),
    train_edge_type (-1 = all), neg_node_type (-1 = all), and
    BaseEstimator's keys (max_id bucketizes the ids)."""

    def __init__(self, model, params: Dict[str, Any], graph,
                 dataflow=None, model_dir: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(model, params, model_dir, device)
        self.graph = graph
        self.dataflow = dataflow
        cfg = self.params_cfg
        self.batch_size = int(cfg.get("batch_size", 32))
        self.num_negs = int(cfg.get("num_negs", 5))
        self.edge_type = int(cfg.get("train_edge_type", -1))
        self.neg_node_type = int(cfg.get("neg_node_type", -1))

    def _batches(self) -> Iterator[Dict]:
        while True:
            src, dst, _ = self.graph.sample_edge(self.batch_size,
                                                 self.edge_type)
            negs = self.graph.sample_node(
                self.batch_size * self.num_negs, self.neg_node_type
            ).reshape(self.batch_size, self.num_negs)
            batch = self.dataflow(src) if self.dataflow else {}
            batch.update({"ids": src if self.dataflow is None
                          else batch.get("ids", src),
                          "src": src, "pos": dst, "negs": negs,
                          "infer_ids": src})
            yield batch

    def train_input_fn(self) -> Iterator[Dict]:
        return self._batches()

    def eval_input_fn(self) -> Iterator[Dict]:
        return self._batches()
