"""The inference half of the estimator (counterpart of
euler_tpu/estimator/base_estimator.py:809-877, estimators.py:140-155 and
:234-253, and the loop of euler_tpu/serving/export.py:405-459
`embed_all`, which serving/export.py and BaseEstimator.infer share).

A deterministic sweep over root ids in fixed batches: the final batch
is padded by repeating its last id, with a metric_mask zeroing the pad
rows. Each batch gets the next seed of the inference stream (stream 1:
seed = 1<<31 | counter), so inference never shifts the training draws.
embed_all runs the model over the sweep and returns (ids, embeddings)
sorted by id, each id's first embedding kept — dedup by first occurrence
drops exactly the pad rows.

`run` and `embed_all` put the model in eval mode (no dropout) for their
forwards and give it back in the mode it was in. The training
estimator (estimators.NodeEstimator) sweeps a split the same way
through its own input paths.
"""

from __future__ import annotations

import contextlib
from typing import (
    Any, Callable, Dict, Iterable, Iterator, Optional, Tuple,
)

import numpy as np
import torch

from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.platform import host_to_device

_INFER_STREAM = 1


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """model.eval() for the block, then the mode it had before."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


class NodeInferencer:
    """Runs a device-sampled model (e.g. DeviceSampledGraphSage) over a
    DeviceFeatureStore and a DeviceNeighborTable on their device."""

    def __init__(self, model: torch.nn.Module, feature_store,
                 neighbor_table, batch_size: int):
        if feature_store.device != neighbor_table.device:
            raise ValueError("feature store and neighbor table must be on "
                             "one device")
        self.model = model
        self.store = feature_store
        self.device = feature_store.device
        self.batch_size = int(batch_size)
        self.static_batch: Dict[str, Any] = dict(neighbor_table.tables)
        self.static_batch["feature_table"] = feature_store.features
        if feature_store.feature_scale is not None:
            self.static_batch["feature_scale"] = feature_store.feature_scale
        if feature_store.labels is not None:
            self.static_batch["label_table"] = feature_store.labels
        self._seed_counter = 0

    def _next_seed(self) -> int:
        self._seed_counter += 1
        return (_INFER_STREAM << 31) | self._seed_counter

    def batch(self, ids: np.ndarray, sample_seed: int) -> Dict[str, Any]:
        """{"rows": [int32 roots on the device], "sample_seed",
        "infer_ids"} for uint64 ids."""
        return {"rows": [host_to_device(self.store.lookup(ids),
                                        self.device)],
                "sample_seed": sample_seed, "infer_ids": ids}

    def infer_input_fn(self, ids: Optional[np.ndarray] = None
                       ) -> Iterator[Dict[str, Any]]:
        """Batches over `ids` (uint64; default every node of the store),
        each {"rows": [int32 roots on the device], "sample_seed",
        "infer_ids": the batch's ids, "metric_mask": [B] float32}."""
        ids = self.store.ids if ids is None else \
            np.asarray(ids, np.uint64).ravel()
        bs = self.batch_size

        def gen():
            for i in range(0, len(ids), bs):
                chunk = ids[i:i + bs]
                n_real = len(chunk)
                if n_real < bs:
                    chunk = np.concatenate(
                        [chunk, np.full(bs - n_real, chunk[-1], np.uint64)])
                mask = np.zeros(bs, np.float32)
                mask[:n_real] = 1.0
                b = self.batch(chunk, self._next_seed())
                b["metric_mask"] = host_to_device(mask, self.device)
                yield b

        return gen()

    def run(self, batch: Dict[str, Any]) -> ModelOutput:
        """One forward of the model, in eval mode, over a batch plus the
        static tables."""
        with eval_mode(self.model), torch.inference_mode():
            return self.model({**batch, **self.static_batch})

    def embed_all(self, input_fn=None) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [N] uint64 sorted unique, embeddings [N, D] float32) over
        input_fn's batches (default: the sweep over every node)."""
        it = self.infer_input_fn() if input_fn is None else (
            input_fn() if callable(input_fn) else input_fn)
        return embed_batches(self.run, it)


def iter_embeddings(run: Callable[[Dict[str, Any]], ModelOutput],
                    batches: Iterable[Dict[str, Any]],
                    id_key: str = "infer_ids"
                    ) -> Iterator[Tuple[Optional[np.ndarray], torch.Tensor]]:
    """(ids, float32 embedding on the device) per batch: `run` is one
    eval-mode forward; ids come from batch[id_key], else batch["ids"]
    (a list holds them first), cut to the embedding's rows; None when
    the batch carries neither."""
    for batch in batches:
        emb = run(batch).embedding.to(torch.float32)
        key = id_key if id_key in batch else (
            "ids" if "ids" in batch else None)
        v = None
        if key is not None:
            v = batch[key]
            v = v[0] if isinstance(v, list) else v
            v = np.asarray(v).ravel()[: emb.shape[0]]
        yield v, emb


def embed_batches(run, batches) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [N] uint64 sorted unique, embeddings [N, D] float32), each
    id's first row kept (dedup by first occurrence drops exactly a
    padded sweep's pad rows). The batches' embeddings stay on the device
    until the sweep ends; the kept rows are gathered there and copied to
    the host once."""
    embs, ids = [], []
    for v, emb in iter_embeddings(run, batches):
        if v is None:
            raise ValueError("export batches must carry infer_ids (or "
                             "ids) aligned with the embedding output")
        if v.shape[0] != emb.shape[0]:
            raise ValueError(f"batch carries {v.shape[0]} ids for "
                             f"{emb.shape[0]} embedding rows")
        embs.append(emb)
        ids.append(v.astype(np.uint64))
    if not embs:
        raise ValueError("input_fn yielded no batches")
    uniq, first = np.unique(np.concatenate(ids), return_index=True)
    keep = torch.from_numpy(first).to(embs[0].device)
    return uniq, torch.cat(embs)[keep].cpu().numpy()
