"""NodeEstimator, EdgeEstimator, GraphEstimator, GaeEstimator and
SampleEstimator (counterpart of euler_tpu/estimator/estimators.py:19-445).

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
  and a sample seed; the model draws the fanout on the device. With
  eval_via_flow, evaluation and inference batches instead come from the
  host eval_dataflow (FastGCN trains on pools drawn on the device and
  evaluates on the host flow's exact 1-hop closures), labels from the
  engine.

Every estimator takes BaseEstimator's mesh (each rank trains on its
data slice of every batch). A data axis > 1 takes only a model whose
batch and loss split over it (parallel.train.check_data_axis): not the
graph models' packed batches, GAE's, DGI's or the solutions'.

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
    store); eval_via_flow: with a device_sampler, evaluation and
    inference go through the host eval_dataflow (the reference's
    estimators.py:26-65, 90-105). params: batch_size (32),
    train_node_type (0), eval_node_type (1), infer_node_type (-1 = all
    nodes), and BaseEstimator's keys.

    feature_store may be a PartitionedFeatureStore (on `mesh`): its
    hub_cache rides the static batch (reads route cache-first) and every
    batch's rows are counted on its gather-leg counters (observe_batch:
    every hop's rows on the host paths, the roots with the device
    sampler, whose hops are drawn on the device), as the reference's
    estimators.py:24-90 count them; health() reports its stats. mesh:
    BaseEstimator's (each rank trains on its data slice)."""

    def __init__(self, model, params: Dict[str, Any], graph, dataflow,
                 label_fid="label", label_dim: Optional[int] = None,
                 model_dir: Optional[str] = None, feature_store=None,
                 eval_dataflow=None, device_sampler=None,
                 eval_via_flow: bool = False, device: DeviceLike = None,
                 mesh=None):
        if eval_via_flow and device_sampler is None:
            raise ValueError("eval_via_flow only applies with a "
                             "device_sampler (host mode already "
                             "evaluates through the flow)")
        if eval_via_flow and (eval_dataflow or dataflow) is None:
            raise ValueError("eval_via_flow needs an eval_dataflow (or "
                             "dataflow) to build the host eval batches")
        if device_sampler is not None and feature_store is None:
            raise ValueError("device_sampler requires a feature_store")
        super().__init__(model, params, model_dir, device, mesh)
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
        self.eval_via_flow = bool(eval_via_flow)
        self._seed_counters = {_TRAIN_STREAM: 0, _EVAL_STREAM: 0}
        self._split_cache: Dict[int, np.ndarray] = {}
        if feature_store is not None:
            self.static_batch["feature_table"] = feature_store.features
            if feature_store.feature_scale is not None:
                self.static_batch["feature_scale"] = \
                    feature_store.feature_scale
            if feature_store.labels is not None:
                self.static_batch["label_table"] = feature_store.labels
            if getattr(feature_store, "hub_size", 0) > 0:
                # the partitioned store's replicated hot rows: feature
                # reads route cache-first while this key is present
                self.static_batch["hub_cache"] = feature_store.hub_cache
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
            if self.eval_via_flow and stream == _EVAL_STREAM:
                # the host protocol's whole batch (levels, adjacencies,
                # features) goes to the device as it is; labels from the
                # engine (the batch carries no rows into the label table)
                batch = flow(roots)
                batch["labels"] = self._labels(roots)
                batch["infer_ids"] = roots
                return batch
            return self._sampler_batch(roots, stream)
        batch = flow(roots)
        if store is not None:
            # every hop's ids become rows of the device tables; the step
            # sees only int32 rows
            batch = {"rows": [store.lookup(i) for i in batch["ids"]],
                     "infer_ids": roots}
            if hasattr(store, "observe_batch"):
                for r in batch["rows"]:
                    store.observe_batch(r)
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
        root_rows = self.feature_store.lookup(roots)
        if hasattr(self.feature_store, "observe_batch"):
            self.feature_store.observe_batch(root_rows)
        batch = {"rows": [root_rows],
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
                 device: DeviceLike = None, mesh=None):
        super().__init__(model, params, model_dir, device, mesh)
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


class GraphEstimator(BaseEstimator):
    """Whole-graph classification (the reference's graph_estimator.py,
    euler_tpu/estimator/estimators.py:290-373): each step packs
    num_graphs small graphs into one node table of static shape.

    graphs: a list of {x [n, D], edge_index [2, e]}; labels [G]. params:
    num_graphs (16), max_nodes and max_edges (0: the largest graph's
    count times num_graphs), seed (0: the train draws' numpy stream and
    the dropout stream), train_indices / eval_indices (default every
    graph), and BaseEstimator's keys."""

    def __init__(self, model, params: Dict[str, Any], graphs, labels,
                 model_dir: Optional[str] = None, device: DeviceLike = None,
                 mesh=None):
        super().__init__(model, params, model_dir, device, mesh)
        self.graphs = graphs
        self.labels = np.asarray(labels)
        cfg = self.params_cfg
        self.num_graphs = int(cfg.get("num_graphs", 16))
        self.max_nodes = int(cfg.get("max_nodes", 0)) or max(
            g["x"].shape[0] for g in graphs) * self.num_graphs
        self.max_edges = int(cfg.get("max_edges", 0)) or max(
            g["edge_index"].shape[1] for g in graphs) * self.num_graphs
        self.rng = np.random.default_rng(int(cfg.get("seed", 0)))

    def _pack(self, idxs, n_real: Optional[int] = None) -> Dict[str, Any]:
        """The graphs idxs packed into one batch padded to max_nodes and
        max_edges: pad nodes join the last slot's graph, pad edges are
        self-loops of the last row; graph_mask is 1 for the first n_real
        slots (default all), 0 for shape padding."""
        n_real = len(idxs) if n_real is None else n_real
        xs, eis, gi, labels = [], [], [], []
        offset = 0
        for slot, gidx in enumerate(idxs):
            g = self.graphs[gidx]
            n = g["x"].shape[0]
            xs.append(g["x"])
            eis.append(g["edge_index"] + offset)
            gi.append(np.full(n, slot, np.int32))
            labels.append(self.labels[gidx])
            offset += n
        x = np.concatenate(xs).astype(np.float32)
        ei = np.concatenate(eis, axis=1).astype(np.int32)
        gi = np.concatenate(gi)
        mask = np.zeros(len(idxs), np.float32)
        mask[:n_real] = 1.0
        n_pad = self.max_nodes - x.shape[0]
        e_pad = self.max_edges - ei.shape[1]
        if n_pad > 0:
            x = np.concatenate([x, np.zeros((n_pad, x.shape[1]), np.float32)])
            gi = np.concatenate([gi, np.full(n_pad, len(idxs) - 1, np.int32)])
        if e_pad > 0:
            sink = self.max_nodes - 1
            ei = np.concatenate(
                [ei, np.full((2, e_pad), sink, np.int32)], axis=1)
        return {"x": x, "edge_index": ei, "graph_index": gi,
                "labels": np.asarray(labels), "graph_mask": mask}

    def _split(self, key: str) -> np.ndarray:
        """The graph indices of params[key], default every graph."""
        split = self.params_cfg.get(key)
        return np.asarray(split) if split is not None else np.arange(
            len(self.graphs))

    def train_input_fn(self) -> Iterator[Dict]:
        """num_graphs graphs a batch, drawn with replacement from the
        train pool by the estimator's numpy stream."""
        pool = self._split("train_indices")
        while True:
            yield self._pack(self.rng.choice(pool, self.num_graphs,
                                             replace=True))

    def eval_steps(self) -> int:
        """Batches of one eval sweep."""
        return max(-(-len(self._split("eval_indices")) // self.num_graphs), 1)

    def eval_input_fn(self) -> Iterator[Dict]:
        """Every eval graph once, in pool order; the last chunk is padded
        with repeats of its last graph under graph_mask 0. evaluate()
        must be given at least eval_steps() steps, or the tail of the
        pool is never seen."""
        pool = self._split("eval_indices")
        for i in range(0, len(pool), self.num_graphs):
            chunk = pool[i:i + self.num_graphs]
            n_real = len(chunk)
            if n_real < self.num_graphs:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1], self.num_graphs - n_real)])
            yield self._pack(chunk, n_real)


class GaeEstimator(BaseEstimator):
    """Graph auto-encoder batches (the reference's gae_estimator.py,
    euler_tpu/estimator/estimators.py:374-416): each batch is the
    dataflow's node table for batch_size roots drawn by the engine's
    sample_node over every node, num_pos positive edges drawn among the
    batch's own edge columns and num_pos negative pairs among its first
    n_real_nodes rows, both by the estimator's numpy stream
    (default_rng(seed)). The dataflow's batch must carry n_real_nodes.
    params: batch_size (32), num_pos (64), seed (0), and
    BaseEstimator's keys."""

    def __init__(self, model, params: Dict[str, Any], graph, dataflow,
                 model_dir: Optional[str] = None, device: DeviceLike = None,
                 mesh=None):
        super().__init__(model, params, model_dir, device, mesh)
        self.graph = graph
        self.dataflow = dataflow
        cfg = self.params_cfg
        self.batch_size = int(cfg.get("batch_size", 32))
        self.num_pos = int(cfg.get("num_pos", 64))
        self.rng = np.random.default_rng(int(cfg.get("seed", 0)))

    def _batches(self) -> Iterator[Dict]:
        while True:
            roots = self.graph.sample_node(self.batch_size, -1)
            batch = self.dataflow(roots)
            # positives are edges of this batch's own table (rows already
            # index it), as the reference draws them
            ei = batch["edge_index"]
            cols = self.rng.integers(0, ei.shape[1], self.num_pos)
            pos_src, pos_dst = ei[0][cols], ei[1][cols]
            neg_src = self.rng.integers(0, batch["n_real_nodes"],
                                        self.num_pos)
            neg_dst = self.rng.integers(0, batch["n_real_nodes"],
                                        self.num_pos)
            batch.update({
                "pos_src": pos_src.astype(np.int32),
                "pos_dst": pos_dst.astype(np.int32),
                "neg_src": neg_src.astype(np.int32),
                "neg_dst": neg_dst.astype(np.int32),
                "infer_ids": roots,
            })
            yield batch

    def train_input_fn(self) -> Iterator[Dict]:
        return self._batches()

    def eval_input_fn(self) -> Iterator[Dict]:
        return self._batches()


class SampleEstimator(BaseEstimator):
    """Training from a line-oriented sample file (the reference's
    estimators.py:SampleEstimator): blank lines skipped, every
    batch_size stripped lines handed to parse_fn(lines) → batch, the
    file read again from the top when it ends, forever. A tail shorter
    than batch_size at the end of the file is dropped, as the reference
    drops it. params: batch_size (32) and BaseEstimator's keys."""

    def __init__(self, model, params: Dict[str, Any], sample_file: str,
                 parse_fn, model_dir: Optional[str] = None,
                 device: DeviceLike = None, mesh=None):
        super().__init__(model, params, model_dir, device=device, mesh=mesh)
        self.sample_file = sample_file
        self.parse_fn = parse_fn
        self.batch_size = int(self.params_cfg.get("batch_size", 32))

    def _batches(self) -> Iterator[Dict]:
        while True:
            with open(self.sample_file) as f:
                lines = []
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    lines.append(line)
                    if len(lines) == self.batch_size:
                        yield self.parse_fn(lines)
                        lines = []

    def train_input_fn(self) -> Iterator[Dict]:
        return self._batches()

    def eval_input_fn(self) -> Iterator[Dict]:
        return self._batches()
