"""Continuous learning over a graph that changes (counterpart of
euler_tpu/estimator/streaming.py, `StreamingDriver`).

One round of the loop:

    driver = StreamingDriver(estimator, engine,
                             device_table=table,        # optional
                             caches=[cache],            # optional
                             serving_client=client,     # optional
                             export_dir="/bundles")
    driver.round({"node_ids": new_ids, "edge_src": s, "edge_dst": d},
                 steps=50)

1. `apply_delta`: the engine applies the delta (a new snapshot, its
   epoch bumped); each cache in `caches` reconciles through its
   `maybe_invalidate()`; the device neighbor/alias tables re-derive the
   dirty rows only (DeviceNeighborTable.patch_rows);
2. `fine_tune(steps)`: the estimator's own train loop runs `steps` more
   steps;
3. `export_and_swap`: a versioned bundle of the current weights and the
   embeddings of the post-delta graph, rolled into the serving fleet
   (ServingClient.swap_fleet).

After a round, served kNN answers over nodes that did not exist at
train start. Each step is counted on the obs registry:
streaming_{deltas,exports,swaps,deltas_refused}_total and the gauge
streaming_graph_epoch, beside the table's alias_rows_patched_total.

The patched tables are new tensors (patch_rows): an estimator that
merged the table's tensors into its static_batch before the delta goes
on reading the old rows, as the reference's does, until the caller
merges the new ones (`estimator.static_batch.update(table.tables)`).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, Optional

from euler_tpu_torch import obs as _obs


class StreamingDriver:
    """Delta → derived-state maintenance → fine-tune → export → fleet
    hot-swap, with one stats dict per step.

    estimator: a BaseEstimator (fine_tune, export_bundle).
    engine: the graph engine deltas go through; a wrapper that holds
      the engine as `_engine` is unwrapped for the table's queries.
    device_table: a DeviceNeighborTable patched per dirty row (split
      layout; the alias table patches with it).
    caches: objects with `maybe_invalidate()` (and optionally
      `cache_stats()`) that reconcile from the engine's dirty history.
    serving_client: a ServingClient whose fleet export_and_swap()
      promotes the fresh bundle into.
    export_dir: where versioned bundles go (one directory a version).
    """

    def __init__(self, estimator, engine, device_table=None,
                 caches: Iterable = (), serving_client=None,
                 export_dir: Optional[str] = None, shards: int = 1):
        self.estimator = estimator
        self.engine = engine
        self.device_table = device_table
        self.caches = list(caches)
        self.serving_client = serving_client
        self.export_dir = export_dir
        self.shards = int(shards)
        self._exports = 0
        reg = _obs.default_registry()
        self._ctr = {
            k: reg.counter(f"streaming_{k}_total", h)
            for k, h in (
                ("deltas", "graph deltas applied through StreamingDriver"),
                ("exports", "bundles exported by StreamingDriver"),
                ("swaps", "serving-fleet hot-swaps by StreamingDriver"),
                ("deltas_refused", "graph deltas refused by a degraded "
                                   "shard (write-ahead log unwritable)"),
            )}
        self._g_epoch = reg.gauge(
            "streaming_graph_epoch",
            "graph epoch after the driver's last delta")

    def apply_delta(self, **delta) -> Dict[str, Any]:
        """Apply one batched delta (GraphEngine.apply_delta's arguments)
        and maintain the derived state: the caches reconcile, the device
        tables patch the dirty rows against the post-delta engine.
        Returns {epoch, dirty, table, caches}."""
        from euler_tpu_torch.graph import EngineError, delta_dirty_ids

        try:
            epoch = self.engine.apply_delta(**delta)
        except EngineError as e:
            # a durable shard with an unwritable log refuses deltas
            if "wal" in str(e).lower():
                self._ctr["deltas_refused"].inc()
            raise
        dirty = delta_dirty_ids(**delta)
        self._ctr["deltas"].inc()
        self._g_epoch.set(epoch)
        table_stats = None
        if self.device_table is not None:
            table_stats = self.device_table.patch_rows(
                self._graph_view(), dirty)
        cache_stats = []
        for cache in self.caches:
            maybe = getattr(cache, "maybe_invalidate", None)
            if callable(maybe):
                maybe()
                stats = getattr(cache, "cache_stats", None)
                cache_stats.append(stats() if callable(stats) else None)
        return {"epoch": epoch, "dirty": int(dirty.size),
                "table": table_stats, "caches": cache_stats}

    def _graph_view(self):
        """The engine the table patch queries (node_rows,
        get_full_neighbor): self.engine with every `_engine` wrapper
        taken off."""
        eng = self.engine
        seen = set()
        while id(eng) not in seen:
            seen.add(id(eng))
            inner = getattr(eng, "_engine", None)
            if inner is None:
                break
            eng = inner
        return eng

    def fine_tune(self, steps: int, input_fn=None) -> Dict[str, Any]:
        """Train `steps` more steps (train's max_steps is the global step
        to reach, so it is offset from the estimator's current step).
        Default input_fn: the estimator's train_input_fn."""
        fn = input_fn if input_fn is not None else \
            self.estimator.train_input_fn
        target = int(self.estimator.step) + int(steps)
        return self.estimator.train(fn, max_steps=target)

    def export_and_swap(self, version: Optional[str] = None,
                        **export_kw) -> Dict[str, Any]:
        """Export a versioned bundle of the current weights and
        embeddings (export_bundle; its input_fn must sweep the
        post-delta ids for new nodes to be served) and, with a
        serving_client, roll it through the fleet (swap_fleet)."""
        if self.export_dir is None:
            raise ValueError("StreamingDriver needs export_dir to export")
        self._exports += 1
        version = version if version is not None else \
            f"stream{self._exports}-{int(time.time())}"
        out_dir = os.path.join(self.export_dir, str(version))
        self.estimator.export_bundle(out_dir, shards=self.shards,
                                     version=version, **export_kw)
        self._ctr["exports"].inc()
        swap = None
        if self.serving_client is not None:
            swap = self.serving_client.swap_fleet(out_dir)
            self._ctr["swaps"].inc()
        return {"version": version, "bundle_dir": out_dir, "swap": swap}

    def round(self, delta: Dict[str, Any], steps: int,
              train_input_fn=None, version: Optional[str] = None,
              **export_kw) -> Dict[str, Any]:
        """One round: apply_delta(**delta), fine_tune(steps),
        export_and_swap(version, **export_kw). Returns {delta, train,
        version, bundle_dir, swap}."""
        out = {"delta": self.apply_delta(**delta)}
        out["train"] = self.fine_tune(steps, input_fn=train_input_fn)
        out.update(self.export_and_swap(version=version, **export_kw))
        return out
