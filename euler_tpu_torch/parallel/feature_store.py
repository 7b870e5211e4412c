"""Device-resident feature store (counterpart of
euler_tpu/parallel/feature_store.py:38-192) on one device.

The node feature matrix is uploaded once; batches carry only int32 row
ids and the model gathers on the device. Layout: rows in engine row
order, a trailing all-zero pad row (unknown ids and sampling pads
gather zeros), optionally int8 with a per-column scale, and a float32
label table with the same pad row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.parallel.placement import put_row_sharded
from euler_tpu_torch.platform import DeviceLike, resolve_device


def quantize_int8(feats: np.ndarray):
    """Per-column symmetric int8 quantization: q = round(x/scale),
    scale = colmax|x|/127; all-zero columns get scale 1. Returns
    (q int8, scale float32 [D]).

    Copy of euler_tpu/parallel/feature_store.py:quantize_int8."""
    scale = np.abs(feats).max(axis=0).astype(np.float32) / 127.0
    scale[scale == 0] = 1.0
    q = np.clip(np.rint(feats.astype(np.float32, copy=False) / scale),
                -127, 127)
    return q.astype(np.int8), scale


def dequantize_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_int8 for gathered rows; the output dtype
    follows scale."""
    return x.to(scale.dtype) * scale


class DeviceFeatureStore:
    """Feature (and label) tables on one device.

    DeviceFeatureStore(graph, feature_ids, ...) reads a graph engine as
    the reference's constructor does (euler_tpu/parallel/
    feature_store.py:69-121): rows in graph.all_node_ids() order, the
    dense features feature_ids side by side, a zero pad row, dtype the
    dtype the table is computed in (the int8 table's scale, with
    quantize="int8"), labels from the dense feature label_fid as
    float32; lookup() is the engine's id → row translation
    (graph.node_rows). keep_host keeps the numpy (features, labels) as
    host_arrays.

    from_arrays: features [N+1, D] with the trailing pad row already
    present; labels: optional [N+1, C] likewise. ids: sorted uint64
    node ids backing lookup(); when omitted, node ids are the table
    rows. quantize="int8" stores int8 with a per-column scale kept in
    scale_dtype (the dtype features are computed in).

    mesh: the tables go to the mesh's device, replicated, or with
    shard_rows=True the feature (int8 included) and label tables
    row-sharded over its 'model' axis (placement.put_row_sharded; the
    reference's feature_store.py:72-105, 126-164); the int8 scale is
    replicated, computed over the whole table, so a sharded read
    dequantizes to the replicated one's bytes."""

    def __init__(self, graph, feature_ids: Sequence, label_fid=None,
                 label_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 keep_host: bool = False, quantize: Optional[str] = None,
                 device: DeviceLike = None, mesh=None,
                 shard_rows: bool = False):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        dev = self._placement(mesh, device, shard_rows)
        ids = graph.all_node_ids()
        feats = graph.get_dense_feature(ids, list(feature_ids))
        if isinstance(feats, list):
            feats = np.concatenate(feats, axis=1)
        feats = np.concatenate(
            [feats, np.zeros((1, feats.shape[1]), feats.dtype)])
        labels = None
        if label_fid is not None:
            labels = graph.get_dense_feature(ids, label_fid, label_dim)
            labels = np.concatenate(
                [labels, np.zeros((1, labels.shape[1]), labels.dtype)])
            labels = labels.astype(np.float32, copy=False)
        if dtype != torch.float32:
            # the reference casts before it quantizes (numpy's bfloat16
            # rounds to nearest even, as torch's cast does)
            feats = torch.from_numpy(feats).to(dtype)
        self._fill(feats, labels, quantize, dtype, dev)
        self.ids = ids
        self._sorted_ids = True
        self._graph = graph
        self.host_arrays = (feats, labels) if keep_host else None

    def _placement(self, mesh, device: DeviceLike,
                   shard_rows: bool) -> torch.device:
        self._mesh, self.shard_rows = mesh, bool(shard_rows)
        return mesh.device if mesh is not None else resolve_device(device)

    def _put(self, x, dev: torch.device) -> torch.Tensor:
        if self.shard_rows:
            return put_row_sharded(x, self._mesh, device=dev)
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def _fill(self, features, labels, quantize, scale_dtype, dev) -> None:
        self.device = dev
        self.pad_row = int(features.shape[0]) - 1
        self.feature_scale = None
        if quantize == "int8":
            q, scale = quantize_int8(
                features.float().numpy() if isinstance(
                    features, torch.Tensor)
                else np.asarray(features, np.float32))
            self.features = self._put(q, dev)
            self.feature_scale = torch.from_numpy(scale).to(
                dev, scale_dtype)
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        else:
            self.features = self._put(features, dev)
        self.labels = None
        if labels is not None:
            self.labels = self._put(
                labels.astype(np.float32, copy=False), dev)

    @classmethod
    def from_arrays(cls, features: np.ndarray,
                    labels: Optional[np.ndarray] = None,
                    ids: Optional[np.ndarray] = None,
                    quantize: Optional[str] = None,
                    scale_dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None, mesh=None,
                    shard_rows: bool = False) -> "DeviceFeatureStore":
        self = cls.__new__(cls)
        dev = self._placement(mesh, device, shard_rows)
        self._fill(features, labels, quantize, scale_dtype, dev)
        self.ids = ids if ids is not None else np.arange(
            self.pad_row, dtype=np.uint64)
        self._sorted_ids = ids is not None
        self._graph = None
        self.host_arrays = None
        return self

    @property
    def dim(self) -> int:
        return int(self.features.shape[-1])

    def lookup(self, ids) -> np.ndarray:
        """uint64 node ids → int32 table rows; unknown ids (the
        engine's default_id sampling pads among them, when the graph
        does not hold id 0) map to the zero pad row."""
        if self._graph is not None:
            return self._graph.node_rows(ids, missing=self.pad_row)
        ids = np.asarray(ids, np.uint64).ravel()
        if not self._sorted_ids:
            # compared as uint64: an id >= 2^63 must not wrap negative
            return np.where(ids < np.uint64(self.pad_row), ids,
                            np.uint64(self.pad_row)).astype(np.int32)
        pos = np.searchsorted(self.ids, ids)
        pos = np.minimum(pos, len(self.ids) - 1)
        hit = self.ids[pos] == ids
        return np.where(hit, pos, self.pad_row).astype(np.int32)
