"""Partitioned device feature tables with a hub-aware replicated cache
(counterpart of euler_tpu/parallel/partitioned_store.py:58-478).

Three tiers, as the reference lays them out:

  hub cache   the top hub_cache_frac highest-degree rows, replicated on
              every rank: gathers route cache-first, so the hot rows
              never cross the interconnect;
  partition   each rank of a model group holds a contiguous 1/K row
              shard (plus the pad sentinel); cold gathers cross it by
              the masked take + SUM ('psum'), the ring or the all-gather
              exchange (ring_exchange), 'auto' picking by the reference's
              cost model on ids shipped × K;
  host        rows past an optional device budget stay in host RAM,
              served through CachedGraphEngine.

Rows are relabeled hub-first (descending degree), so hub membership is
`row < H` and the hub cache is the table's first H rows;
apply_permutation maps companion tables (neighbors, labels) into the
same row space. A gather on the mesh is byte-identical to a plain take
on the unpartitioned table, float32 and int8 alike: hub rows come from
a verbatim copy, cold rows from a single-owner exchange, and the
combine is a select.

The host-side row accounting (route_batch, observe_batch, cache_stats)
is a copy of the reference's; its counters are on euler_tpu_torch.obs
under the reference's names (table_gather_{local,cached,remote,host}_
rows_total, hub_cache_{hits,misses}_total, table_hbm_bytes: the
per-device bytes of the tier).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.feature_store import quantize_int8
from euler_tpu_torch.parallel.placement import (
    put_replicated, put_row_sharded, row_shard,
)
from euler_tpu_torch.parallel.ring_exchange import (
    allgather_lookup, pick_lookup_strategy, ring_lookup,
)

__all__ = ["PartitionedFeatureStore", "hub_routed_take"]

_STORE_IDS = itertools.count()


def _last_row(table: torch.Tensor) -> int:
    """The index of the (global, padded) table's trailing zero row."""
    info = row_shard(table)
    return (info.global_rows if info is not None else table.shape[0]) - 1


def hub_routed_take(base_take: Callable, hub_cache: torch.Tensor) -> Callable:
    """base_take(table, rows) with cache-first hub routing: rows below
    the cache height H read the replicated hub_cache (the table's first
    H rows, verbatim); only the cold tail reaches base_take, with hub
    positions sent to the table's trailing zero row, so a hub row never
    rides the remote leg. The combine is a select: the bytes equal an
    unrouted gather's, int8 included."""
    H = int(hub_cache.shape[0])
    if H == 0:
        return base_take

    def take(table, rows):
        is_hub = rows < H
        cached = hub_cache[rows.clamp_max(H - 1).long()]
        cold = base_take(table, torch.where(
            is_hub, torch.full_like(rows, _last_row(table)), rows))
        mask = is_hub.reshape(tuple(is_hub.shape)
                              + (1,) * (cached.dim() - is_hub.dim()))
        return torch.where(mask, cached, cold)

    return take


class PartitionedFeatureStore:
    """Mesh-partitioned node feature table + replicated hub cache.

    Device-row layout (after the hub-first permutation):
      [0, H)            hub rows: the partition's first rows, and
                        replicated verbatim as `hub_cache`
      [H, dev_rows)     cold rows, contiguous 1/K shards over `axis`
      dev_rows          the all-zero pad sentinel
      > dev_rows        put_row_sharded's zero padding

    Ranks past dev_rows (host_rows of them) are the host-RAM overflow
    tier: lookup_with_overflow flags them and fetch_host_rows serves
    them through CachedGraphEngine.

        store = PartitionedFeatureStore(graph, ["feature"], mesh=mesh,
                                        hub_cache_frac=0.01)
        rows = store.lookup(ids_u64)        # host: ids → device rows
        out = store.make_gather()(rows_dev) # on the mesh, exact
    """

    def __init__(self, graph, feature_ids: Sequence, *, mesh,
                 axis: str = "model", hub_cache_frac: float = 0.0,
                 device_rows: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 quantize: Optional[str] = None,
                 host_cache_bytes: int = 64 << 20,
                 name: Optional[str] = None):
        ids = graph.all_node_ids()
        feats = graph.get_dense_feature(ids, list(feature_ids))
        if isinstance(feats, list):
            feats = np.concatenate(feats, axis=1)
        feats = np.asarray(feats, np.float32)
        # degree ranking from the engine at build time: the hub set is
        # the measured skew, not a guess
        offs = graph.get_full_neighbor(ids)[0].astype(np.int64)
        self._init_from(feats, np.diff(offs), mesh=mesh, axis=axis,
                        hub_cache_frac=hub_cache_frac,
                        device_rows=device_rows, quantize=quantize,
                        scale_dtype=dtype, name=name)
        self._graph = graph
        self._feature_ids = list(feature_ids)
        self._host_engine = None
        if self.host_rows > 0:
            from euler_tpu_torch.graph import CachedGraphEngine

            self._host_engine = CachedGraphEngine(
                graph, budget_bytes=int(host_cache_bytes),
                name=f"{self.name}_host")

    @classmethod
    def from_arrays(cls, features: np.ndarray, degrees: np.ndarray, *,
                    mesh, axis: str = "model", hub_cache_frac: float = 0.0,
                    quantize: Optional[str] = None,
                    scale_dtype: torch.dtype = torch.float32,
                    name: Optional[str] = None):
        """From a prebuilt [N+1, D] table (trailing pad row) or [N, D],
        and per-node degrees [N]; node ids are the original table rows.
        No graph engine, so no host-overflow tier."""
        self = cls.__new__(cls)
        self._graph = None
        self._feature_ids = None
        self._host_engine = None
        self._init_from(np.asarray(features), np.asarray(degrees),
                        mesh=mesh, axis=axis,
                        hub_cache_frac=hub_cache_frac, device_rows=None,
                        quantize=quantize, scale_dtype=scale_dtype,
                        name=name)
        return self

    # -- build -------------------------------------------------------------
    def _init_from(self, feats: np.ndarray, degrees: np.ndarray, *, mesh,
                   axis, hub_cache_frac, device_rows, quantize,
                   scale_dtype, name):
        n = int(degrees.shape[0])
        if feats.shape[0] == n:          # engine path: pad row not yet
            feats = np.concatenate(
                [feats, np.zeros((1, feats.shape[1]), feats.dtype)])
        if feats.shape[0] != n + 1:
            raise ValueError(
                f"features must be [N, D] or [N+1, D] for N={n} degrees,"
                f" got {feats.shape}")
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.device
        self.k = int(mesh.size(axis))
        self.name = name or f"ptable{next(_STORE_IDS)}"
        if not 0.0 <= float(hub_cache_frac) < 1.0:
            raise ValueError(
                f"hub_cache_frac must be in [0, 1), got {hub_cache_frac}")
        self.hub_size = int(round(float(hub_cache_frac) * n))
        self.dev_rows = n if device_rows is None else int(device_rows)
        self.dev_rows = max(min(self.dev_rows, n), self.hub_size)
        self.host_rows = n - self.dev_rows
        self.pad_row = self.dev_rows
        # hub-first permutation, old row → device row; host-resident
        # ranks shift +1 past the pad sentinel
        order = np.argsort(-degrees, kind="stable").astype(np.int64)
        rank = np.arange(n, dtype=np.int32)
        perm = np.empty(n + 1, np.int32)
        perm[order] = np.where(rank < self.dev_rows, rank, rank + 1)
        perm[n] = self.dev_rows                   # old pad → sentinel
        self.permutation = perm                   # old row → new row
        self.order = order                        # degree rank → old row
        tot = float(degrees.sum())
        self.hub_mass = float(
            degrees[order[:self.hub_size]].sum() / tot) if tot else 0.0
        self.degree_max = int(degrees.max()) if n else 0
        self.degree_mean = float(degrees.mean()) if n else 0.0

        self.feature_scale = None
        if quantize == "int8":
            # one scale over the FULL table: hub cache, shard and the
            # unpartitioned reference share one quantization
            feats, scale = quantize_int8(np.asarray(feats, np.float32))
            self.feature_scale = put_replicated(scale, mesh).to(scale_dtype)
        elif quantize is not None:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        dev = np.empty((self.dev_rows + 1, feats.shape[1]), feats.dtype)
        np.take(feats, order[:self.dev_rows], axis=0, out=dev[:-1])
        dev[-1] = 0                               # pad sentinel row
        self.hub_cache = put_replicated(
            np.ascontiguousarray(dev[:self.hub_size]), mesh)
        self.features = put_row_sharded(dev, mesh, axis=axis)
        self.labels = None
        self.dim = int(dev.shape[1])
        self._elem_bytes = dev.dtype.itemsize
        info = row_shard(self.features)
        self._global_rows = info.global_rows if info else int(dev.shape[0])
        shard_rows = -(-self._global_rows // max(self.k, 1))
        self.per_chip_bytes = (
            shard_rows * self.dim * self._elem_bytes
            + self.hub_size * self.dim * self._elem_bytes
            + (self.dim * 4 if self.feature_scale is not None else 0))
        self._wire_obs()

    def _wire_obs(self):
        reg = _obs.default_registry()
        lab = {"store": self.name}
        self._ctr = {
            leg: reg.counter(
                f"table_gather_{leg}_rows_total",
                h, ("store",)).labels(**lab)
            for leg, h in (
                ("local", "gathered rows owned by the requesting shard"),
                ("cached", "gathered rows served by the hub cache"),
                ("remote", "gathered rows crossing devices (cold, "
                           "non-local)"),
                ("host", "gathered rows served from host RAM overflow"),
            )}
        self._ctr_hub_hits = reg.counter(
            "hub_cache_hits_total",
            "table gathers answered by the replicated hub cache",
            ("store",)).labels(**lab)
        self._ctr_hub_misses = reg.counter(
            "hub_cache_misses_total",
            "table gathers past the hub cache (local + remote + host)",
            ("store",)).labels(**lab)
        self._g_hbm = reg.gauge(
            "table_hbm_bytes",
            "per-device bytes held by the partitioned table tier "
            "(shard + hub cache + scale)", ("store",)).labels(**lab)
        self._g_hbm.set(self.per_chip_bytes)
        _obs.register_health(self.name, self.cache_stats)

    # -- host side ---------------------------------------------------------
    def lookup(self, ids) -> np.ndarray:
        """u64 node ids → int32 device rows (hub-first space); unknown
        ids → the pad sentinel. Ids evicted to the host tier raise."""
        rows, host = self.lookup_with_overflow(ids)
        if host.any():
            raise ValueError(
                f"{int(host.sum())} of {host.size} ids resolve to "
                "host-overflow rows; use lookup_with_overflow() + "
                "fetch_host_rows() on this store (device_rows="
                f"{self.dev_rows} < {self.dev_rows + self.host_rows})")
        return rows

    def lookup_with_overflow(self, ids):
        """(device_rows int32, host_mask bool): host-resident ids come
        back as the pad sentinel with True in host_mask."""
        ids = np.asarray(ids, np.uint64).ravel()
        if self._graph is not None:
            old = self._graph.node_rows(
                ids, missing=len(self.permutation) - 1)
        else:
            old = np.minimum(ids, np.uint64(len(self.permutation) - 1))
        new = self.permutation[np.asarray(old, np.int64)]
        host = new > self.dev_rows  # shifted ranks past the sentinel
        return (np.where(host, self.pad_row, new).astype(np.int32),
                host)

    def fetch_host_rows(self, ids) -> np.ndarray:
        """Dense features of host-overflow ids through the
        CachedGraphEngine tier; counted as the 'host' leg."""
        if self._host_engine is None:
            raise ValueError("store has no host tier "
                             "(device_rows covers every row)")
        ids = np.asarray(ids, np.uint64).ravel()
        feats = self._host_engine.get_dense_feature(
            ids, list(self._feature_ids))
        if isinstance(feats, list):
            feats = np.concatenate(feats, axis=1)
        self._ctr["host"].inc(int(ids.size))
        self._ctr_hub_misses.inc(int(ids.size))
        return feats

    def apply_permutation(self, table: np.ndarray,
                          remap_values: bool = False) -> np.ndarray:
        """A [N+1, ...] companion table (original row space, trailing pad
        row) in this store's hub-first row space; remap_values also
        rewrites its int32 row values (neighbor ids). Host-overflow
        stores refuse."""
        if self.host_rows:
            raise ValueError(
                "apply_permutation needs a fully device-resident store "
                f"(host_rows={self.host_rows}): companion tables cannot "
                "reference host-evicted rows")
        n = len(self.permutation) - 1
        if table.shape[0] != n + 1:
            raise ValueError(
                f"companion table has {table.shape[0]} rows, store row "
                f"space is {n + 1}")
        out = np.empty_like(table)
        np.take(table, self.order, axis=0, out=out[:-1])
        out[-1] = table[-1]                       # pad row kept verbatim
        if remap_values:
            np.take(self.permutation, out, out=out)
        return out

    def route_batch(self, rows) -> dict:
        """Deterministic traffic split of device rows [B] (duplicates
        count): hub rows 'cached'; with K shards the batch splits into K
        contiguous position blocks (the exchanges' layout) and a cold
        row is 'local' when its owner is its block's shard, else
        'remote'. Also the strategy make_gather('auto') takes."""
        rows = np.asarray(rows).ravel()
        b = int(rows.size)
        hub = rows < self.hub_size
        if self.k <= 1:
            local = int((~hub).sum())
            remote = 0
        else:
            rows_per = self._global_rows // self.k
            owner = np.minimum(rows // max(rows_per, 1), self.k - 1)
            block = np.arange(b) * self.k // max(b, 1)
            local = int(((~hub) & (owner == block)).sum())
            remote = int(((~hub) & (owner != block)).sum())
        return {"rows": b, "cached": int(hub.sum()), "local": local,
                "remote": remote,
                "strategy": pick_lookup_strategy(
                    b, self.k, self.dim, self._elem_bytes)}

    def observe_batch(self, rows) -> dict:
        """route_batch, and the counters bumped."""
        r = self.route_batch(rows)
        self._ctr["cached"].inc(r["cached"])
        self._ctr["local"].inc(r["local"])
        self._ctr["remote"].inc(r["remote"])
        self._ctr_hub_hits.inc(r["cached"])
        self._ctr_hub_misses.inc(r["local"] + r["remote"])
        return r

    def cache_stats(self) -> dict:
        """The registry-backed stats view (the health provider)."""
        hits = int(self._ctr_hub_hits.value)
        misses = int(self._ctr_hub_misses.value)
        return {
            "k_shards": self.k,
            "hub_size": self.hub_size,
            "hub_mass": round(self.hub_mass, 6),
            "dev_rows": self.dev_rows,
            "host_rows": self.host_rows,
            "degree_max": self.degree_max,
            "degree_mean": round(self.degree_mean, 3),
            "per_chip_bytes": self.per_chip_bytes,
            "hub_hits": hits,
            "hub_misses": misses,
            "hit_rate": round(hits / max(hits + misses, 1), 6),
            "gather_rows": {
                leg: int(c.value) for leg, c in self._ctr.items()},
        }

    # -- device side -------------------------------------------------------
    @property
    def tables(self) -> dict:
        """static_batch keys: the row-sharded table, the replicated hub
        cache (gathers route cache-first when present), the int8 scale
        and a label table when one is set."""
        out = {"feature_table": self.features}
        if self.hub_size > 0:
            out["hub_cache"] = self.hub_cache
        if self.feature_scale is not None:
            out["feature_scale"] = self.feature_scale
        if self.labels is not None:
            out["label_table"] = self.labels
        return out

    def make_gather(self, strategy: str = "auto",
                    n_ids_hint: Optional[int] = None) -> Callable:
        """gather(rows) → the rows' features on every rank of the model
        group (rows: this rank's, the same on the group), byte-identical
        to a plain take on the unpartitioned table. strategy: 'psum'
        (the masked take + SUM), 'allgather', 'ring', or 'auto' (the
        cost model on ids shipped × K: n_ids_hint, else the row count).
        An unpartitioned store (K == 1) takes locally. Hub rows route
        cache-first in every strategy; the exchanges pad rows to a
        multiple of K with the pad sentinel and slice it off."""
        if strategy not in ("auto", "psum", "allgather", "ring"):
            raise ValueError(f"unknown gather strategy {strategy!r}")
        from euler_tpu_torch.parallel.device_sampler import make_table_gather

        if self.k <= 1 or strategy == "psum":
            routed = make_table_gather(self.mesh, self.axis,
                                       hub_cache=self.hub_cache)
            return lambda rows: routed(self.features, rows)
        group = self.mesh.group(self.axis)
        me = self.mesh.index(self.axis)

        def exchange(kind):
            fn = ring_lookup if kind == "ring" else allgather_lookup

            def base(table, rows):
                b = rows.shape[0]
                pad = (-b) % self.k
                if pad:
                    rows = torch.cat([rows, rows.new_full(
                        (pad,), self.pad_row)])
                n = rows.shape[0] // self.k
                block = fn(table, rows[me * n:(me + 1) * n], self.mesh,
                           self.axis)
                out = collectives.gather_replicated(block, group)
                return out[:b] if pad else out

            return hub_routed_take(base, self.hub_cache)

        routed = {}

        def gather(rows):
            kind = strategy
            if kind == "auto":
                n = n_ids_hint or int(rows.shape[0])
                kind = pick_lookup_strategy(n, self.k, self.dim,
                                            self._elem_bytes)
            if kind not in routed:
                routed[kind] = exchange(kind)
            return routed[kind](self.features, rows)

        return gather
