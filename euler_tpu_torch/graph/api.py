"""Numpy-facing wrapper over the native graph engine (copy of
euler_tpu/graph/api.py: `GraphBuilder`, `GraphEngine`, the local
in-process engine, `seed` and `delta_dirty_ids`).

Every op is a batch call that takes and returns numpy arrays of fixed
shapes (padded with `default_id`); nothing here is torch. The engine is
the port's own build of the same C++ (core/lib.py), so a graph built
here and one built by the reference from the same arrays answer every
read alike, and, under the same `seed` on the calling thread, every
draw byte for byte. Each library keeps its own global RNG: seeding one
leaves the other's stream where it was.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from euler_tpu_torch.core import lib as _libmod
from euler_tpu_torch.core.lib import (
    EngineError, c_f32p, c_i32p, c_i64p, c_u64p,
)

__all__ = ["GraphEngine", "GraphBuilder", "EngineError", "seed",
           "delta_dirty_ids"]

DENSE, SPARSE, BINARY = 0, 1, 2


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _opt_types(edge_types) -> tuple:
    """Normalize an edge-type filter to (ptr, n). None/empty → all types."""
    if edge_types is None:
        return None, 0
    et = _i32(edge_types).ravel()
    if et.size == 0:
        return None, 0
    return et, et.size


class _Result:
    """RAII wrapper for the variable-size EtResult handle."""

    def __init__(self, lib):
        self._lib = lib
        self.h = lib.etres_new()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._lib.etres_free(self.h)

    def offsets(self) -> np.ndarray:
        n = self._lib.etres_offsets_len(self.h)
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        return np.ctypeslib.as_array(self._lib.etres_offsets(self.h), (n,)).copy()

    def u64(self) -> np.ndarray:
        n = self._lib.etres_u64_len(self.h)
        if n == 0:
            return np.zeros(0, dtype=np.uint64)
        return np.ctypeslib.as_array(self._lib.etres_u64(self.h), (n,)).copy()

    def f32(self) -> np.ndarray:
        n = self._lib.etres_f32_len(self.h)
        if n == 0:
            return np.zeros(0, dtype=np.float32)
        return np.ctypeslib.as_array(self._lib.etres_f32(self.h), (n,)).copy()

    def i32(self) -> np.ndarray:
        n = self._lib.etres_i32_len(self.h)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        return np.ctypeslib.as_array(self._lib.etres_i32(self.h), (n,)).copy()

    def bytes_(self) -> bytes:
        n = self._lib.etres_bytes_len(self.h)
        if n == 0:
            return b""
        return ctypes.string_at(self._lib.etres_bytes(self.h), n)


class GraphBuilder:
    """Accumulates nodes/edges/features, then .finalize() → GraphEngine."""

    def __init__(self):
        self._lib = _libmod.load()
        self.h = self._lib.etg_builder_new()
        self._feature_names: dict = {"node": {}, "edge": {}}

    def set_num_types(self, num_node_types: int, num_edge_types: int):
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_num_types(self.h, num_node_types, num_edge_types),
        )
        return self

    def set_type_name(self, type_id: int, name: str, edge: bool = False):
        """Name a node/edge type so training code can refer to it by
        name (reference type_ops get_node_type_id / get_edge_type_id;
        the json data-prep declares type names the same way). Unnamed
        types keep their numeric-string default."""
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_type_name(
                self.h, 1 if edge else 0, type_id, name.encode()),
        )
        return self

    def set_feature(self, fid: int, kind: int, dim: int, name: str = "", edge: bool = False):
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_feature(
                self.h, 1 if edge else 0, fid, kind, dim, name.encode()
            ),
        )
        self._feature_names["edge" if edge else "node"][name or str(fid)] = fid
        return self

    def add_nodes(self, ids, types=None, weights=None):
        ids = _u64(ids).ravel()
        n = ids.size
        tp = _ptr(_i32(types).ravel(), c_i32p) if types is not None else None
        wp = _ptr(_f32(weights).ravel(), c_f32p) if weights is not None else None
        _libmod.check(
            self._lib,
            self._lib.etg_builder_add_nodes(self.h, n, _ptr(ids, c_u64p), tp, wp),
        )
        return self

    def add_edges(self, src, dst, types=None, weights=None):
        src = _u64(src).ravel()
        dst = _u64(dst).ravel()
        n = src.size
        tp = _ptr(_i32(types).ravel(), c_i32p) if types is not None else None
        wp = _ptr(_f32(weights).ravel(), c_f32p) if weights is not None else None
        _libmod.check(
            self._lib,
            self._lib.etg_builder_add_edges(
                self.h, n, _ptr(src, c_u64p), _ptr(dst, c_u64p), tp, wp
            ),
        )
        return self

    def set_node_dense(self, ids, fid: int, values):
        ids = _u64(ids).ravel()
        values = _f32(values).reshape(ids.size, -1)
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_node_dense(
                self.h, _ptr(ids, c_u64p), ids.size, fid, values.shape[1],
                _ptr(values, c_f32p),
            ),
        )
        return self

    def set_node_sparse(self, ids, fid: int, offsets, values):
        ids = _u64(ids).ravel()
        offsets = _u64(offsets).ravel()
        values = _u64(values).ravel()
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_node_sparse(
                self.h, _ptr(ids, c_u64p), ids.size, fid,
                _ptr(offsets, c_u64p), _ptr(values, c_u64p),
            ),
        )
        return self

    def set_node_binary(self, node_id: int, fid: int, data: bytes):
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_node_binary(self.h, node_id, fid, data, len(data)),
        )
        return self

    def set_edge_binary(self, src: int, dst: int, etype: int, fid: int,
                        data: bytes):
        """Attach raw bytes to one edge (reference GetEdgeBinaryFeature
        storage side, tf_euler/kernels/get_edge_binary_feature_op.cc —
        there populated from the JSON 'binary_feature' edge block)."""
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_edge_binary(
                self.h, src, dst, etype, fid, data, len(data)),
        )
        return self

    def set_edge_dense(self, src, dst, types, fid: int, values):
        src = _u64(src).ravel()
        dst = _u64(dst).ravel()
        types = _i32(types if types is not None else np.zeros(src.size)).ravel()
        values = _f32(values).reshape(src.size, -1)
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_edge_dense(
                self.h, _ptr(src, c_u64p), _ptr(dst, c_u64p), _ptr(types, c_i32p),
                src.size, fid, values.shape[1], _ptr(values, c_f32p),
            ),
        )
        return self

    def set_edge_sparse(self, src: int, dst: int, etype: int, fid: int, values):
        values = _u64(values).ravel()
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_edge_sparse(
                self.h, src, dst, etype, fid, _ptr(values, c_u64p), values.size
            ),
        )
        return self

    def set_graph_labels(self, ids, labels) -> None:
        """Assign nodes to whole-graph labels (graph classification;
        reference graph_label batching). Label 0 = unlabeled."""
        ids = _u64(ids).ravel()
        labels = _u64(labels).ravel()
        _libmod.check(
            self._lib,
            self._lib.etg_builder_set_graph_labels(
                self.h, _ptr(ids, c_u64p), _ptr(labels, c_u64p), ids.size))

    def finalize(self, build_in_adjacency: bool = True) -> "GraphEngine":
        gh = self._lib.etg_builder_finalize(self.h, 1 if build_in_adjacency else 0)
        if gh < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        self.h = None
        return GraphEngine(gh, feature_names=self._feature_names)


def _delta_arrays(node_ids, node_types, node_weights, edge_src, edge_dst,
                  edge_types, edge_weights):
    """Normalize a batched delta into contiguous arrays + validate the
    parallel lengths — one definition shared by the embedded and remote
    engines so both reject the same malformed deltas."""
    nid = _u64(node_ids if node_ids is not None else []).ravel()
    n = nid.size
    nt = _i32(node_types).ravel() if node_types is not None \
        else np.zeros(n, np.int32)
    nw = _f32(node_weights).ravel() if node_weights is not None \
        else np.ones(n, np.float32)
    es = _u64(edge_src if edge_src is not None else []).ravel()
    ed = _u64(edge_dst if edge_dst is not None else []).ravel()
    e = es.size
    et = _i32(edge_types).ravel() if edge_types is not None \
        else np.zeros(e, np.int32)
    ew = _f32(edge_weights).ravel() if edge_weights is not None \
        else np.ones(e, np.float32)
    if nt.size != n or nw.size != n:
        raise ValueError(
            f"delta node columns disagree: {n} ids, {nt.size} types, "
            f"{nw.size} weights")
    if ed.size != e or et.size != e or ew.size != e:
        raise ValueError(
            f"delta edge columns disagree: {e} src, {ed.size} dst, "
            f"{et.size} types, {ew.size} weights")
    if n == 0 and e == 0:
        raise ValueError("empty delta: nothing to apply")
    return nid, nt, nw, es, ed, et, ew


def delta_dirty_ids(node_ids=None, edge_src=None, edge_dst=None,
                    **_ignored) -> np.ndarray:
    """Sorted unique node ids a delta touches (nodes ∪ edge endpoints) —
    what the engine records as the epoch's dirty set. Callers that just
    issued the delta can invalidate locally from this instead of asking
    the engine (CachedGraphEngine.apply_delta does)."""
    parts = [np.asarray(a, dtype=np.uint64).ravel()
             for a in (node_ids, edge_src, edge_dst) if a is not None]
    if not parts:
        return np.zeros(0, dtype=np.uint64)
    return np.unique(np.concatenate(parts))


class GraphEngine:
    """In-process graph engine. Each finalized graph SNAPSHOT is
    immutable; apply_delta() builds and atomically swaps in a new
    snapshot behind this handle (graph_epoch() bumps, queries bound to
    the handle see it, in-flight readers finish on the old one)."""

    def __init__(self, handle: int, feature_names: Optional[dict] = None):
        self._lib = _libmod.load()
        self.h = handle
        self._feature_names = feature_names or {"node": {}, "edge": {}}
        if not self._feature_names["node"]:
            self._load_feature_names()

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def load(cls, directory: str, shard_idx: int = 0, shard_num: int = 1,
             data_type: int = 0, build_in_adjacency: bool = True) -> "GraphEngine":
        lib = _libmod.load()
        h = lib.etg_load(directory.encode(), shard_idx, shard_num, data_type,
                         1 if build_in_adjacency else 0)
        if h < 0:
            raise EngineError(lib.etg_last_error().decode())
        return cls(h)

    def dump(self, directory: str, num_partitions: int = 1,
             by_graph: bool = False) -> None:
        """by_graph=True partitions by graph label (whole graphs stay on
        one shard — the graph_partition serving mode)."""
        if "://" not in directory:  # remote urls (hdfs://) manage dirs
            import os

            os.makedirs(directory, exist_ok=True)
        _libmod.check(self._lib, self._lib.etg_dump(self.h, directory.encode(),
                                                    num_partitions,
                                                    1 if by_graph else 0))

    def close(self) -> None:
        if self.h is not None:
            self._lib.etg_free(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _load_feature_names(self):
        for edge, key in ((0, "node"), (1, "edge")):
            n = (self._lib.etg_num_edge_features(self.h) if edge
                 else self._lib.etg_num_node_features(self.h))
            for fid in range(max(n, 0)):
                kind = ctypes.c_int32()
                dim = ctypes.c_int64()
                buf = ctypes.create_string_buffer(256)
                rc = self._lib.etg_feature_info(
                    self.h, edge, fid, ctypes.byref(kind), ctypes.byref(dim), buf, 256
                )
                if rc == 0:
                    name = buf.value.decode() or str(fid)
                    self._feature_names[key][name] = fid

    # -- introspection -----------------------------------------------------
    @property
    def node_count(self) -> int:
        return self._lib.etg_node_count(self.h)

    @property
    def edge_count(self) -> int:
        return self._lib.etg_edge_count(self.h)

    @property
    def num_node_types(self) -> int:
        return self._lib.etg_num_node_types(self.h)

    @property
    def num_edge_types(self) -> int:
        return self._lib.etg_num_edge_types(self.h)

    def feature_id(self, name, edge: bool = False) -> int:
        if isinstance(name, (int, np.integer)):
            return int(name)
        return self._feature_names["edge" if edge else "node"][name]

    def type_id(self, name_or_id, edge: bool = False) -> int:
        """Type name (or numeric string / int) → type id (reference
        type_ops). Raises KeyError for unknown names."""
        if isinstance(name_or_id, (int, np.integer)):
            return int(name_or_id)
        t = self._lib.etg_type_id(self.h, 1 if edge else 0,
                                  str(name_or_id).encode())
        if t < 0:
            kind = "edge" if edge else "node"
            raise KeyError(f"unknown {kind} type name: {name_or_id!r}")
        return int(t)

    def type_name(self, type_id: int, edge: bool = False) -> str:
        cap = 256
        while True:
            buf = ctypes.create_string_buffer(cap)
            _libmod.check(
                self._lib,
                self._lib.etg_type_name(self.h, 1 if edge else 0, type_id,
                                        buf, cap),
            )
            # snprintf truncates silently; a full buffer means retry
            # bigger so long names round-trip through type_id()
            if len(buf.value) < cap - 1:
                return buf.value.decode()
            cap *= 2

    def feature_dim(self, fid_or_name, edge: bool = False) -> int:
        fid = self.feature_id(fid_or_name, edge)
        kind = ctypes.c_int32()
        dim = ctypes.c_int64()
        _libmod.check(
            self._lib,
            self._lib.etg_feature_info(self.h, 1 if edge else 0, fid,
                                       ctypes.byref(kind), ctypes.byref(dim), None, 0),
        )
        return int(dim.value)

    def node_rows(self, ids, missing: int = 0) -> np.ndarray:
        """Batch u64 node id → int32 engine row (all_node_ids order);
        unknown ids map to `missing`. The fast path for device-resident
        feature-table training input (DeviceFeatureStore passes its zero
        pad row)."""
        ids = _u64(ids).ravel()
        out = np.zeros(ids.size, dtype=np.int32)
        _libmod.check(
            self._lib,
            self._lib.etg_node_rows(self.h, _ptr(ids, c_u64p), ids.size,
                                    missing, _ptr(out, c_i32p)))
        return out

    def all_node_ids(self) -> np.ndarray:
        out = np.zeros(self.node_count, dtype=np.uint64)
        _libmod.check(self._lib, self._lib.etg_all_node_ids(self.h, _ptr(out, c_u64p)))
        return out

    # -- streaming deltas --------------------------------------------------
    def graph_epoch(self) -> int:
        """Monotonic version stamp of the current snapshot (0 =
        as-finalized; each apply_delta bumps it)."""
        e = self._lib.etg_graph_epoch(self.h)
        if e < 0:
            raise EngineError(self._lib.etg_last_error().decode())
        return int(e)

    def apply_delta(self, node_ids=None, node_types=None,
                    node_weights=None, edge_src=None, edge_dst=None,
                    edge_types=None, edge_weights=None) -> int:
        """Apply a batched delta (add/update nodes and edges) and swap
        in the new immutable snapshot. Node rows are append-only (an
        existing node keeps its engine row; its type/weight update in
        place), an edge that already exists updates its weight, and new
        edges/nodes append — so derived row-indexed state (device
        feature/neighbor tables) stays valid for untouched rows and can
        be patched per dirty row. Returns the new epoch."""
        nid, nt, nw, es, ed, et, ew = _delta_arrays(
            node_ids, node_types, node_weights, edge_src, edge_dst,
            edge_types, edge_weights)
        out_epoch = ctypes.c_int64()
        _libmod.check(
            self._lib,
            self._lib.etg_apply_delta(
                self.h, nid.size, _ptr(nid, c_u64p), _ptr(nt, c_i32p),
                _ptr(nw, c_f32p), es.size, _ptr(es, c_u64p),
                _ptr(ed, c_u64p), _ptr(et, c_i32p), _ptr(ew, c_f32p),
                ctypes.byref(out_epoch)))
        return int(out_epoch.value)

    def delta_since(self, from_epoch: int):
        """(epoch, covered, dirty_ids): the sorted unique node ids
        touched by every delta after `from_epoch`. covered=False means
        the bounded per-epoch history no longer reaches from_epoch —
        the caller must treat EVERYTHING as dirty (full flush)."""
        out_epoch = ctypes.c_int64()
        covered = ctypes.c_int32()
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_delta_since(self.h, int(from_epoch), res.h,
                                          ctypes.byref(out_epoch),
                                          ctypes.byref(covered)))
            ids = res.u64()
        return int(out_epoch.value), bool(covered.value), ids

    def all_node_weights(self) -> np.ndarray:
        """Per-node weights in engine-row order (all_node_ids order) —
        backs device-resident weighted global sampling."""
        out = np.zeros(self.node_count, dtype=np.float32)
        _libmod.check(self._lib, self._lib.etg_all_node_weights(
            self.h, _ptr(out, c_f32p)))
        return out

    def node_weight_sums(self) -> np.ndarray:
        out = np.zeros(self.num_node_types, dtype=np.float32)
        _libmod.check(self._lib, self._lib.etg_node_weight_sums(self.h, _ptr(out, c_f32p)))
        return out

    def edge_weight_sums(self) -> np.ndarray:
        out = np.zeros(self.num_edge_types, dtype=np.float32)
        _libmod.check(self._lib, self._lib.etg_edge_weight_sums(self.h, _ptr(out, c_f32p)))
        return out

    # -- sampling ----------------------------------------------------------
    def sample_node(self, count: int, node_type: int = -1) -> np.ndarray:
        out = np.zeros(count, dtype=np.uint64)
        _libmod.check(
            self._lib, self._lib.etg_sample_node(self.h, node_type, count, _ptr(out, c_u64p))
        )
        return out

    def sample_node_with_types(self, types) -> np.ndarray:
        types = _i32(types).ravel()
        out = np.zeros(types.size, dtype=np.uint64)
        _libmod.check(
            self._lib,
            self._lib.etg_sample_node_with_types(
                self.h, _ptr(types, c_i32p), types.size, _ptr(out, c_u64p)
            ),
        )
        return out

    def sample_edge(self, count: int, edge_type: int = -1):
        src = np.zeros(count, dtype=np.uint64)
        dst = np.zeros(count, dtype=np.uint64)
        tp = np.zeros(count, dtype=np.int32)
        _libmod.check(
            self._lib,
            self._lib.etg_sample_edge(
                self.h, edge_type, count, _ptr(src, c_u64p), _ptr(dst, c_u64p),
                _ptr(tp, c_i32p),
            ),
        )
        return src, dst, tp

    def get_node_type(self, ids) -> np.ndarray:
        ids = _u64(ids).ravel()
        out = np.zeros(ids.size, dtype=np.int32)
        _libmod.check(
            self._lib,
            self._lib.etg_get_node_type(self.h, _ptr(ids, c_u64p), ids.size, _ptr(out, c_i32p)),
        )
        return out

    def sample_neighbor(self, ids, count: int, edge_types=None, default_id: int = 0,
                        in_edges: bool = False):
        ids = _u64(ids).ravel()
        n = ids.size
        et, n_et = _opt_types(edge_types)
        etp = _ptr(et, c_i32p) if et is not None else None
        out_ids = np.zeros((n, count), dtype=np.uint64)
        out_w = np.zeros((n, count), dtype=np.float32)
        out_t = np.zeros((n, count), dtype=np.int32)
        fn = self._lib.etg_sample_in_neighbor if in_edges else self._lib.etg_sample_neighbor
        _libmod.check(
            self._lib,
            fn(self.h, _ptr(ids, c_u64p), n, etp, n_et, count, default_id,
               _ptr(out_ids, c_u64p), _ptr(out_w, c_f32p), _ptr(out_t, c_i32p)),
        )
        return out_ids, out_w, out_t

    def get_top_k_neighbor(self, ids, k: int, edge_types=None, default_id: int = 0):
        ids = _u64(ids).ravel()
        n = ids.size
        et, n_et = _opt_types(edge_types)
        etp = _ptr(et, c_i32p) if et is not None else None
        out_ids = np.zeros((n, k), dtype=np.uint64)
        out_w = np.zeros((n, k), dtype=np.float32)
        out_t = np.zeros((n, k), dtype=np.int32)
        _libmod.check(
            self._lib,
            self._lib.etg_get_top_k_neighbor(
                self.h, _ptr(ids, c_u64p), n, etp, n_et, k, default_id,
                _ptr(out_ids, c_u64p), _ptr(out_w, c_f32p), _ptr(out_t, c_i32p)),
        )
        return out_ids, out_w, out_t

    def get_full_neighbor(self, ids, edge_types=None, sorted_by_id: bool = False,
                          in_edges: bool = False):
        """Returns (offsets[n+1], nbr_ids, weights, types) CSR arrays."""
        ids = _u64(ids).ravel()
        et, n_et = _opt_types(edge_types)
        etp = _ptr(et, c_i32p) if et is not None else None
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_full_neighbor(
                    self.h, _ptr(ids, c_u64p), ids.size, etp, n_et,
                    1 if sorted_by_id else 0, 1 if in_edges else 0, res.h),
            )
            return res.offsets(), res.u64(), res.f32(), res.i32()

    def get_neighbor_edges(self, ids, edge_types=None):
        """The *edges* to each node's out-neighbors (reference
        get_neighbor_edge_op.cc / GQL outE at gremlin.l:21).

        Returns (offsets[n+1], src, dst, types, weights): CSR arrays where
        row i's slice holds the (src=ids[i], dst, type) edge triples —
        directly chainable into get_edge_dense_feature and friends.
        """
        ids = _u64(ids).ravel()
        off, nb, w, t = self.get_full_neighbor(ids, edge_types=edge_types)
        src = np.repeat(ids, np.diff(off.astype(np.int64)))
        return off, src, nb, t, w

    @property
    def graph_label_count(self) -> int:
        return int(self._lib.etg_graph_label_count(self.h))

    def sample_graph_label(self, count: int) -> np.ndarray:
        """Uniform sample of whole-graph labels (reference
        SampleGraphLabel)."""
        out = np.zeros(count, dtype=np.uint64)
        _libmod.check(self._lib, self._lib.etg_sample_graph_label(
            self.h, count, _ptr(out, c_u64p)))
        return out

    def get_graph_by_label(self, labels):
        """(offsets[n+1], node_ids) CSR: the nodes of each labeled graph
        (reference GetGraphByLabel)."""
        labels = _u64(labels).ravel()
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_graph_by_label(
                    self.h, _ptr(labels, c_u64p), labels.size, res.h))
            return res.offsets(), res.u64()

    def sample_fanout(self, roots, counts: Sequence[int], edge_types=None,
                      default_id: int = 0):
        """Multi-hop expansion in one native call.

        Returns (ids_per_hop, weights_per_hop, types_per_hop); hop i arrays
        have shape [n_roots * prod(counts[:i+1])].
        """
        roots = _u64(roots).ravel()
        n = roots.size
        counts_arr = _i32(counts).ravel()
        n_hops = counts_arr.size
        # per-hop edge-type lists: edge_types is None | flat list (shared) |
        # list of per-hop lists
        if edge_types is None:
            et_flat, et_offsets = None, None
        else:
            if len(edge_types) > 0 and isinstance(
                    edge_types[0], (list, tuple, np.ndarray)):
                per_hop = [list(h) for h in edge_types]
                if len(per_hop) != n_hops:
                    raise ValueError(
                        f"per-hop edge_types has {len(per_hop)} entries, "
                        f"expected {n_hops} (one per hop)"
                    )
            else:
                per_hop = [list(edge_types)] * n_hops
            offs = [0]
            flat = []
            for hop_list in per_hop:
                flat.extend(hop_list)
                offs.append(len(flat))
            et_flat = _i32(flat) if flat else None
            et_offsets = np.asarray(offs, dtype=np.int64)
        sizes = []
        m = n
        for c in counts_arr:
            m *= int(c)
            sizes.append(m)
        ids_bufs = [np.zeros(s, dtype=np.uint64) for s in sizes]
        w_bufs = [np.zeros(s, dtype=np.float32) for s in sizes]
        t_bufs = [np.zeros(s, dtype=np.int32) for s in sizes]
        ids_ptrs = (c_u64p * n_hops)(*[_ptr(b, c_u64p) for b in ids_bufs])
        w_ptrs = (c_f32p * n_hops)(*[_ptr(b, c_f32p) for b in w_bufs])
        t_ptrs = (c_i32p * n_hops)(*[_ptr(b, c_i32p) for b in t_bufs])
        _libmod.check(
            self._lib,
            self._lib.etg_sample_fanout(
                self.h, _ptr(roots, c_u64p), n, _ptr(counts_arr, c_i32p), n_hops,
                _ptr(et_flat, c_i32p) if et_flat is not None else None,
                _ptr(et_offsets, c_i64p) if et_offsets is not None else None,
                default_id, ids_ptrs, w_ptrs, t_ptrs),
        )
        return ids_bufs, w_bufs, t_bufs

    def random_walk(self, roots, walk_len: int, p: float = 1.0, q: float = 1.0,
                    edge_types=None, default_id: int = 0) -> np.ndarray:
        roots = _u64(roots).ravel()
        et, n_et = _opt_types(edge_types)
        etp = _ptr(et, c_i32p) if et is not None else None
        out = np.zeros((roots.size, walk_len + 1), dtype=np.uint64)
        _libmod.check(
            self._lib,
            self._lib.etg_random_walk(
                self.h, _ptr(roots, c_u64p), roots.size, walk_len, p, q,
                default_id, etp, n_et, _ptr(out, c_u64p)),
        )
        return out

    def sample_layerwise(self, roots, layer_sizes: Sequence[int], edge_types=None,
                         default_id: int = 0, weight_func: str = ""):
        """weight_func '' (identity) or 'sqrt' — the reference's
        optional transform of the accumulated candidate weight before
        the draw (local_sample_layer_op.cc:94)."""
        roots = _u64(roots).ravel()
        sizes = _i32(layer_sizes).ravel()
        n_layers = sizes.size
        et, n_et = _opt_types(edge_types)
        etp = _ptr(et, c_i32p) if et is not None else None
        wf = {"": 0, "sqrt": 1}.get(weight_func)
        if wf is None:
            raise ValueError(
                f"weight_func must be '' or 'sqrt', got {weight_func!r}")
        bufs = [np.zeros(int(s), dtype=np.uint64) for s in sizes]
        ptrs = (c_u64p * n_layers)(*[_ptr(b, c_u64p) for b in bufs])
        _libmod.check(
            self._lib,
            self._lib.etg_sample_layerwise(
                self.h, _ptr(roots, c_u64p), roots.size, _ptr(sizes, c_i32p),
                n_layers, etp, n_et, default_id, wf, ptrs),
        )
        return bufs

    # -- features ----------------------------------------------------------
    def get_dense_feature(self, ids, fids, dims=None) -> list:
        """Returns [n, dim] float32 per fid (list), zero-filled for misses."""
        ids = _u64(ids).ravel()
        single = not isinstance(fids, (list, tuple, np.ndarray))
        fid_list = [fids] if single else list(fids)
        fid_list = [self.feature_id(f) for f in fid_list]
        if dims is None:
            dim_list = [self.feature_dim(f) for f in fid_list]
        else:
            dim_list = [dims] if single else list(dims)
        outs = []
        for fid, dim in zip(fid_list, dim_list):
            out = np.zeros((ids.size, dim), dtype=np.float32)
            _libmod.check(
                self._lib,
                self._lib.etg_get_dense_feature(
                    self.h, _ptr(ids, c_u64p), ids.size, fid, dim, _ptr(out, c_f32p)),
            )
            outs.append(out)
        return outs[0] if single else outs

    def get_sparse_feature(self, ids, fid) -> tuple:
        """Returns (offsets[n+1], values) CSR of uint64."""
        ids = _u64(ids).ravel()
        fid = self.feature_id(fid)
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_sparse_feature(self.h, _ptr(ids, c_u64p), ids.size, fid, res.h),
            )
            return res.offsets(), res.u64()

    def get_binary_feature(self, ids, fid) -> tuple:
        ids = _u64(ids).ravel()
        fid = self.feature_id(fid)
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_binary_feature(self.h, _ptr(ids, c_u64p), ids.size, fid, res.h),
            )
            return res.offsets(), res.bytes_()

    def get_edge_dense_feature(self, src, dst, types, fids, dims=None):
        src = _u64(src).ravel()
        dst = _u64(dst).ravel()
        types = _i32(types).ravel()
        single = not isinstance(fids, (list, tuple, np.ndarray))
        fid_list = [fids] if single else list(fids)
        fid_list = [self.feature_id(f, edge=True) for f in fid_list]
        if dims is None:
            dim_list = [self.feature_dim(f, edge=True) for f in fid_list]
        else:
            dim_list = [dims] if single else list(dims)
        outs = []
        for fid, dim in zip(fid_list, dim_list):
            out = np.zeros((src.size, dim), dtype=np.float32)
            _libmod.check(
                self._lib,
                self._lib.etg_get_edge_dense_feature(
                    self.h, _ptr(src, c_u64p), _ptr(dst, c_u64p), _ptr(types, c_i32p),
                    src.size, fid, dim, _ptr(out, c_f32p)),
            )
            outs.append(out)
        return outs[0] if single else outs

    def get_edge_sparse_feature(self, src, dst, types, fid) -> tuple:
        src = _u64(src).ravel()
        dst = _u64(dst).ravel()
        types = _i32(types).ravel()
        fid = self.feature_id(fid, edge=True)
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_edge_sparse_feature(
                    self.h, _ptr(src, c_u64p), _ptr(dst, c_u64p), _ptr(types, c_i32p),
                    src.size, fid, res.h),
            )
            return res.offsets(), res.u64()

    def get_edge_binary_feature(self, src, dst, types, fid) -> tuple:
        """Returns (offsets[n+1], bytes): per-edge raw byte strings, CSR
        (reference GetEdgeBinaryFeature, euler/core/api/api.h:44-95)."""
        src = _u64(src).ravel()
        dst = _u64(dst).ravel()
        types = _i32(types).ravel()
        fid = self.feature_id(fid, edge=True)
        with _Result(self._lib) as res:
            _libmod.check(
                self._lib,
                self._lib.etg_get_edge_binary_feature(
                    self.h, _ptr(src, c_u64p), _ptr(dst, c_u64p), _ptr(types, c_i32p),
                    src.size, fid, res.h),
            )
            return res.offsets(), res.bytes_()


def seed(value: int) -> None:
    """Seed the engine's RNG (current thread) for reproducible sampling."""
    _libmod.load().etg_seed(value)
