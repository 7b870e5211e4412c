"""Model export: versioned, checksummed serving bundles (copy of
euler_tpu/serving/export.py:68-459; the port imports nothing of
euler_tpu). The files are the reference's, name for name and key for
key: a bundle either package writes loads and verifies in the other
(tests/test_torch_serving.py holds both directions).

The train→serve seam (the reference's real deployment loop: train node
embeddings offline, serve embedding-lookup / kNN queries online — the
same split TF-GNN makes the centerpiece of its production design). A
**ModelBundle** is a directory holding everything the serving tier
needs, with a manifest that makes corruption detectable at load:

  manifest.json     schema_version, model spec, per-file sha256 + sizes
  params.npz        flattened trained parameter pytree ("path" → array)
  embeddings.npy    [N, D] float32 node-embedding matrix (embed_all)
  ids.npy           [N] uint64 node ids, SORTED ascending (the serving
                    lookup is a searchsorted over this order)
  index.npz         IVFFlat coarse-quantizer state (tools/knn.py)

Loads verify the schema version and every file's checksum; a missing,
truncated, or bit-flipped file raises BundleCorruptionError instead of
serving garbage. Writes go through a temp directory + atomic rename so
a crashed export never leaves a half-written bundle at the target path.

**Sharded layout** (`save_sharded`): the serving-fleet analogue of the
contiguous 1/K row shards the reference's
`euler_tpu/parallel/partitioned_store.py` cuts device tables into — shard s holds rows [lo_s, hi_s) of the SORTED id order,
so each shard's ids stay sorted (lookup is still a searchsorted) and
id-range routing is a binary search over shard lower bounds:

  manifest.json        one manifest for the whole fleet: schema, a
                       "shards" block (count, per-shard row + id
                       ranges) and per-file sha256 for EVERY shard
  params.npz           shared trained params (written once)
  embeddings.<s>.npy   shard s's [n_s, D] rows
  ids.<s>.npy          shard s's sorted ids
  index.<s>.npz        per-shard IVFFlat state (trained on the shard)

`load_shard(dir, s)` verifies and loads ONE shard (plus the shared
params) — corruption in shard 3 never blocks shard 0's replica from
serving. `load()` on a sharded dir reassembles the full bundle (the
concatenation of contiguous sorted shards is the original sorted
order), which is what parity tests diff the fleet against.

Bundles carry a **version** (meta key ``bundle_version``, defaulting
to the training step) — the identity the zero-downtime hot-swap
protocol flips between and reports in info()/healthz.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["SCHEMA_VERSION", "BundleCorruptionError", "ModelBundle",
           "embed_all", "shard_bounds", "bundle_shard_count"]

SCHEMA_VERSION = 1

_PARAMS = "params.npz"
_EMB = "embeddings.npy"
_IDS = "ids.npy"
_INDEX = "index.npz"
_MANIFEST = "manifest.json"


def shard_bounds(count: int, shards: int):
    """Contiguous near-equal [lo, hi) row ranges — the same contiguous
    1/K convention the partitioned device tables use. Every shard is
    non-empty (a replica serving zero rows has no id range to route)."""
    if shards < 1:
        raise ValueError("shards must be >= 1")
    if count < shards:
        raise ValueError(
            f"cannot cut {count} embedding rows into {shards} shards")
    return [(round(i * count / shards), round((i + 1) * count / shards))
            for i in range(shards)]


class BundleCorruptionError(RuntimeError):
    """The bundle on disk does not match its manifest (missing file,
    checksum mismatch, unsupported schema) — refuse to serve it."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _json_safe(v: Any) -> Any:
    """Best-effort JSON projection of a model-spec value; non-trivial
    objects collapse to their repr (the spec is documentation, not a
    reconstruction format)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return repr(v)


class ModelBundle:
    """In-memory view of an export bundle (see module docstring)."""

    def __init__(self, params: Dict[str, np.ndarray],
                 embeddings: np.ndarray, ids: np.ndarray,
                 index_state: Optional[Dict[str, np.ndarray]] = None,
                 model_spec: Optional[Dict[str, Any]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        ids = np.ascontiguousarray(ids, dtype=np.uint64)
        embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[0] != ids.shape[0]:
            raise ValueError(
                f"embeddings {embeddings.shape} must be [N, D] aligned "
                f"with ids {ids.shape}")
        if ids.size and not (ids[:-1] < ids[1:]).all():
            raise ValueError("ids must be sorted ascending and unique "
                             "(the serving lookup is a searchsorted)")
        self.params = dict(params or {})
        self.embeddings = embeddings
        self.ids = ids
        self.index_state = dict(index_state) if index_state else None
        self.model_spec = dict(model_spec or {})
        self.meta = dict(meta or {})

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1]) if self.embeddings.size else 0

    @property
    def count(self) -> int:
        return int(self.ids.shape[0])

    @property
    def version(self) -> str:
        """Bundle identity for the hot-swap protocol: the explicit
        ``bundle_version`` meta when the export set one, else the
        training step it was cut at."""
        v = self.meta.get("bundle_version")
        if v is None:
            v = f"step{self.meta.get('global_step', 0)}"
        return str(v)

    @property
    def shard(self) -> int:
        """This bundle's shard index (0 for an unsharded bundle)."""
        return int(self.meta.get("shard", 0))

    @property
    def num_shards(self) -> int:
        return int(self.meta.get("num_shards", 1))

    def build_index(self):
        """IVFFlatIndex over this bundle's embeddings — from the stored
        state when present (exactly the exported clustering), trained
        fresh otherwise."""
        from euler_tpu_torch.tools.knn import IVFFlatIndex

        if self.index_state is not None:
            return IVFFlatIndex.from_state(self.index_state,
                                           self.embeddings, self.ids)
        idx = IVFFlatIndex()
        idx.train_add(self.embeddings, self.ids)
        return idx

    # -- persistence -------------------------------------------------------
    def save(self, out_dir: str) -> str:
        """Write the bundle under out_dir (atomic: temp dir + rename).
        Returns out_dir."""
        out_dir = os.path.abspath(out_dir)
        tmp = out_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, _EMB), self.embeddings)
        np.save(os.path.join(tmp, _IDS), self.ids)
        np.savez(os.path.join(tmp, _PARAMS),
                 **{k: np.asarray(v) for k, v in self.params.items()})
        files = [_EMB, _IDS, _PARAMS]
        if self.index_state is not None:
            np.savez(os.path.join(tmp, _INDEX), **self.index_state)
            files.append(_INDEX)
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "model_spec": _json_safe(self.model_spec),
            "meta": _json_safe(self.meta),
            "embedding_count": self.count,
            "embedding_dim": self.dim,
            "files": {
                name: {"sha256": _sha256(os.path.join(tmp, name)),
                       "bytes": os.path.getsize(os.path.join(tmp, name))}
                for name in files
            },
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        os.replace(tmp, out_dir)
        return out_dir

    # -- sharded persistence ----------------------------------------------
    def save_sharded(self, out_dir: str, shards: int, nlist: int = 64,
                     nprobe: int = 8, index: bool = True,
                     seed: int = 0) -> str:
        """Write a partitioned fleet bundle (see module docstring):
        contiguous 1/N row shards, a per-shard IVFFlat trained on each
        shard's rows, one manifest with every shard's sha256. Atomic
        like save(). Returns out_dir."""
        from euler_tpu_torch.tools.knn import IVFFlatIndex

        bounds = shard_bounds(self.count, shards)
        out_dir = os.path.abspath(out_dir)
        tmp = out_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _PARAMS),
                 **{k: np.asarray(v) for k, v in self.params.items()})
        files = [_PARAMS]
        for s, (lo, hi) in enumerate(bounds):
            emb_s = np.ascontiguousarray(self.embeddings[lo:hi])
            ids_s = np.ascontiguousarray(self.ids[lo:hi])
            np.save(os.path.join(tmp, f"embeddings.{s}.npy"), emb_s)
            np.save(os.path.join(tmp, f"ids.{s}.npy"), ids_s)
            files += [f"embeddings.{s}.npy", f"ids.{s}.npy"]
            if index and hi - lo >= 2:
                idx = IVFFlatIndex(nlist=nlist, nprobe=nprobe, seed=seed)
                idx.train_add(emb_s, ids_s)
                np.savez(os.path.join(tmp, f"index.{s}.npz"),
                         **idx.state_dict())
                files.append(f"index.{s}.npz")
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "model_spec": _json_safe(self.model_spec),
            "meta": _json_safe(self.meta),
            "embedding_count": self.count,
            "embedding_dim": self.dim,
            "shards": {
                "count": shards,
                "rows": [[lo, hi] for lo, hi in bounds],
                "id_ranges": [[int(self.ids[lo]), int(self.ids[hi - 1])]
                              for lo, hi in bounds],
            },
            "files": {
                name: {"sha256": _sha256(os.path.join(tmp, name)),
                       "bytes": os.path.getsize(os.path.join(tmp, name))}
                for name in files
            },
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        os.replace(tmp, out_dir)
        return out_dir

    @classmethod
    def load(cls, bundle_dir: str, verify: bool = True) -> "ModelBundle":
        """Load + (by default) verify a bundle. A sharded bundle is
        reassembled whole (contiguous sorted shards concatenate back to
        the original sorted order; the global index is not stored, so
        index_state is None). Any mismatch between disk and manifest
        raises BundleCorruptionError."""
        manifest = _read_manifest(bundle_dir)
        files = manifest.get("files", {})
        sharding = manifest.get("shards")
        if sharding is not None:
            _check_files(bundle_dir, files, verify)
            n = int(sharding.get("count", 0))
            if n < 1:
                raise BundleCorruptionError(
                    f"sharded manifest with shard count {n}")
            if _PARAMS not in files:
                raise BundleCorruptionError(
                    f"manifest lists no {_PARAMS}")
            embs, idss = [], []
            for s in range(n):
                for name in (f"embeddings.{s}.npy", f"ids.{s}.npy"):
                    if name not in files:
                        raise BundleCorruptionError(
                            f"manifest lists no {name}")
                embs.append(np.load(
                    os.path.join(bundle_dir, f"embeddings.{s}.npy")))
                idss.append(np.load(
                    os.path.join(bundle_dir, f"ids.{s}.npy")))
            with np.load(os.path.join(bundle_dir, _PARAMS)) as z:
                params = {k: z[k] for k in z.files}
            bundle = cls(params, np.concatenate(embs),
                         np.concatenate(idss), None,
                         manifest.get("model_spec"), manifest.get("meta"))
        else:
            _check_files(bundle_dir, files, verify)
            for required in (_EMB, _IDS, _PARAMS):
                if required not in files:
                    raise BundleCorruptionError(
                        f"manifest lists no {required}")
            emb = np.load(os.path.join(bundle_dir, _EMB))
            ids = np.load(os.path.join(bundle_dir, _IDS))
            with np.load(os.path.join(bundle_dir, _PARAMS)) as z:
                params = {k: z[k] for k in z.files}
            index_state = None
            if _INDEX in files:
                with np.load(os.path.join(bundle_dir, _INDEX)) as z:
                    index_state = {k: z[k] for k in z.files}
            bundle = cls(params, emb, ids, index_state,
                         manifest.get("model_spec"), manifest.get("meta"))
        if bundle.count != manifest.get("embedding_count") \
                or bundle.dim != manifest.get("embedding_dim"):
            raise BundleCorruptionError(
                "embedding shape disagrees with manifest")
        return bundle

    @classmethod
    def load_shard(cls, bundle_dir: str, shard: int,
                   verify: bool = True) -> "ModelBundle":
        """Load ONE shard of a sharded bundle (plus the shared params)
        as a self-contained ModelBundle whose meta carries the shard
        identity (shard / num_shards). Only the shard's own files and
        params are checksummed, so corruption in another shard never
        blocks this replica."""
        manifest = _read_manifest(bundle_dir)
        sharding = manifest.get("shards")
        if sharding is None:
            raise BundleCorruptionError(
                f"{bundle_dir} is not a sharded bundle (no shards block "
                "in the manifest); load() serves it whole")
        n = int(sharding.get("count", 0))
        if not 0 <= shard < n:
            raise BundleCorruptionError(
                f"shard {shard} out of range for {n}-shard bundle")
        files = manifest.get("files", {})
        names = [_PARAMS, f"embeddings.{shard}.npy", f"ids.{shard}.npy"]
        index_name = f"index.{shard}.npz"
        if index_name in files:
            names.append(index_name)
        for name in names:
            if name not in files:
                raise BundleCorruptionError(f"manifest lists no {name}")
        _check_files(bundle_dir, {k: files[k] for k in names}, verify)
        emb = np.load(os.path.join(bundle_dir, f"embeddings.{shard}.npy"))
        ids = np.load(os.path.join(bundle_dir, f"ids.{shard}.npy"))
        with np.load(os.path.join(bundle_dir, _PARAMS)) as z:
            params = {k: z[k] for k in z.files}
        index_state = None
        if index_name in files:
            with np.load(os.path.join(bundle_dir, index_name)) as z:
                index_state = {k: z[k] for k in z.files}
        meta = dict(manifest.get("meta") or {})
        meta["shard"] = int(shard)
        meta["num_shards"] = n
        return cls(params, emb, ids, index_state,
                   manifest.get("model_spec"), meta)


def _read_manifest(bundle_dir: str) -> Dict[str, Any]:
    mpath = os.path.join(bundle_dir, _MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise BundleCorruptionError(
            f"unreadable manifest {mpath}: {e}") from e
    ver = manifest.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise BundleCorruptionError(
            f"bundle schema_version {ver!r} unsupported "
            f"(this build reads {SCHEMA_VERSION})")
    return manifest


def _check_files(bundle_dir: str, files: Dict[str, Any],
                 verify: bool) -> None:
    """Presence + (when verify) size/sha256 check of the listed files."""
    for name, info in files.items():
        path = os.path.join(bundle_dir, name)
        if not os.path.isfile(path):
            raise BundleCorruptionError(f"bundle file missing: {name}")
        if not verify:
            continue
        size = os.path.getsize(path)
        if size != info.get("bytes"):
            raise BundleCorruptionError(
                f"{name}: size {size} != manifest {info.get('bytes')}")
        digest = _sha256(path)
        if digest != info.get("sha256"):
            raise BundleCorruptionError(
                f"{name}: sha256 mismatch (corrupt bundle)")


def bundle_shard_count(bundle_dir: str) -> int:
    """Shard count of the bundle at bundle_dir (1 for an unsharded
    bundle). Raises BundleCorruptionError on an unreadable manifest."""
    sharding = _read_manifest(bundle_dir).get("shards")
    return int(sharding["count"]) if sharding else 1


def embed_all(estimator, input_fn: Optional[Callable[[], Iterator]] = None,
              steps: int = 1_000_000
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched inference pass materializing the node-embedding matrix:
    (ids [N] uint64 sorted unique, embeddings [N, D] float32).

    Runs the estimator's model in eval mode over input_fn (default: the
    estimator's own infer_input_fn sweep), each batch on the
    estimator's device merged with its tables, and keeps each id's
    FIRST embedding — a padded final batch repeats its last id, and
    dedup by first occurrence drops exactly the pad rows. Output is
    sorted by id: the canonical serving order (lookup = searchsorted).
    The rows stay on the device until the pass ends and cross to the
    host once."""
    from euler_tpu_torch.estimator.infer import embed_batches

    if input_fn is None:
        input_fn = getattr(estimator, "infer_input_fn", None)
        if input_fn is None:
            raise ValueError("estimator has no infer_input_fn; pass an "
                             "input_fn of batches carrying infer_ids")
    it = input_fn() if callable(input_fn) else input_fn
    estimator._maybe_restore()
    return embed_batches(estimator.run_eval, itertools.islice(it, steps))
