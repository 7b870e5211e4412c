"""Device-resident feature store (counterpart of
euler_tpu/parallel/feature_store.py:38-172) on one device.

The node feature matrix is uploaded once; batches carry only int32 row
ids and the model gathers on the device. Layout: rows in engine row
order, a trailing all-zero pad row (unknown ids and sampling pads
gather zeros), optionally int8 with a per-column scale, and a float32
label table with the same pad row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    """Feature (and label) tables on one device, built from arrays.

    features: [N+1, D] with the trailing pad row already present;
    labels: optional [N+1, C] likewise. ids: sorted uint64 node ids
    backing lookup(); when omitted, node ids are the table rows.
    quantize="int8" stores int8 with a per-column scale kept in
    scale_dtype (the dtype features are computed in)."""

    def __init__(self):
        raise TypeError("use DeviceFeatureStore.from_arrays")

    @classmethod
    def from_arrays(cls, features: np.ndarray,
                    labels: Optional[np.ndarray] = None,
                    ids: Optional[np.ndarray] = None,
                    quantize: Optional[str] = None,
                    scale_dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> "DeviceFeatureStore":
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self.device = dev
        self.pad_row = int(features.shape[0]) - 1
        self.ids = ids if ids is not None else np.arange(
            self.pad_row, dtype=np.uint64)
        self._sorted_ids = ids is not None
        self.feature_scale = None
        if quantize == "int8":
            q, scale = quantize_int8(np.asarray(features, np.float32))
            self.features = torch.from_numpy(q).to(dev)
            self.feature_scale = torch.from_numpy(scale).to(
                dev, scale_dtype)
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        else:
            self.features = torch.from_numpy(
                np.ascontiguousarray(features)).to(dev)
        self.labels = None
        if labels is not None:
            self.labels = torch.from_numpy(np.ascontiguousarray(
                labels.astype(np.float32, copy=False))).to(dev)
        return self

    @property
    def dim(self) -> int:
        return int(self.features.shape[-1])

    def lookup(self, ids) -> np.ndarray:
        """uint64 node ids → int32 table rows; unknown ids map to the
        zero pad row."""
        ids = np.asarray(ids, np.uint64).ravel()
        if not self._sorted_ids:
            # compared as uint64: an id >= 2^63 must not wrap negative
            return np.where(ids < np.uint64(self.pad_row), ids,
                            np.uint64(self.pad_row)).astype(np.int32)
        pos = np.searchsorted(self.ids, ids)
        pos = np.minimum(pos, len(self.ids) - 1)
        hit = self.ids[pos] == ids
        return np.where(hit, pos, self.pad_row).astype(np.int32)
