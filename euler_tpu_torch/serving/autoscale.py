"""Serving-tier autoscaling: grow/shrink a shard's replica set on the
observed shed rate (copy of euler_tpu/serving/autoscale.py over the
port's InferenceServer; the port imports nothing of euler_tpu).

The serving stack already has every mechanism a scale event
needs — explicit admission control (``ShedError`` → counted ``shed``,
never a silent drop), registry discovery with replica rotation/p2c on
the client, and zero-downtime drain semantics. This module adds the
POLICY: an autoscaler that polls the replicas' shed counters, scales
**up** (new ``InferenceServer`` replica over the same bundle, registry
discovery routes traffic to it within the clients' re-resolution TTL)
when the windowed shed rate crosses the threshold, and scales **down**
(``InferenceServer.drain()``: deregister → grace → bounded queue drain
→ stop) after enough consecutive calm windows.

Deliberately synchronous: ``step()`` evaluates one window and performs
at most ONE scale action. The caller owns the cadence (a loop thread, a
bench harness, a test) — policy stays testable and deterministic.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.serving.server import InferenceServer

__all__ = ["ServingAutoscaler"]


class ServingAutoscaler:
    """Shed-rate-driven replica autoscaler for ONE serving shard.

    bundle: bundle directory (or ModelBundle) every new replica loads.
    registry / service / shard: the discovery identity replicas join.
    min_replicas / max_replicas: the fleet-size clamp (1→3 is the
      acceptance shape).
    shed_rate_up: scale up when window sheds / window requests crosses
      this (sheds are EXPLICIT statuses — the client retried them, so
      every one is a user-visible latency event).
    calm_windows_down: scale down after this many consecutive windows
      with zero sheds (0 disables auto-down; tests drive explicitly).
    server_kwargs: forwarded to every InferenceServer the scaler
      starts (max_batch, flush_ms, max_queue, inject_* ...).
    """

    def __init__(self, bundle, registry: str, service: str = "default",
                 shard: int = 0, min_replicas: int = 1,
                 max_replicas: int = 3, shed_rate_up: float = 0.01,
                 calm_windows_down: int = 0,
                 server_kwargs: Optional[dict] = None):
        self.bundle = bundle
        self.registry = registry
        self.service = service
        self.shard = int(shard)
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.shed_rate_up = float(shed_rate_up)
        self.calm_windows_down = int(calm_windows_down)
        self.server_kwargs = dict(server_kwargs or {})
        self._mu = threading.Lock()
        self._replicas: Dict[int, InferenceServer] = {}
        self._next_idx = 0
        # per-replica last cumulative totals: diffs are computed per
        # replica so one replica's transient health() failure cannot
        # re-enter its lifetime totals as a fake window (the spurious
        # scale-up a fleet-wide diff suffers)
        self._last_by: Dict[int, dict] = {}
        self._calm = 0
        reg = _obs.default_registry()
        lab = {"service": service, "shard": str(self.shard)}
        self._ctr_up = reg.counter(
            "serving_autoscale_up_total",
            "replicas started by the autoscaler",
            ("service", "shard")).labels(**lab)
        self._ctr_down = reg.counter(
            "serving_autoscale_down_total",
            "replicas drained by the autoscaler",
            ("service", "shard")).labels(**lab)
        self._g_replicas = reg.gauge(
            "serving_autoscale_replicas",
            "replicas currently owned by the autoscaler",
            ("service", "shard")).labels(**lab)

    # -- fleet bookkeeping -------------------------------------------------
    def adopt(self, server: InferenceServer) -> None:
        """Take ownership of an already-running replica (the initial
        fleet the scaler grows from). Seeds the per-replica window
        bookkeeping with the server's CURRENT cumulative totals — a
        long-running adoptee's lifetime counts must not read as one
        giant first window (a guaranteed spurious scale-up)."""
        try:
            h = server.health()
            seed = {"requests": sum(h.get("requests", {}).values()),
                    "shed": int(h.get("shed", 0))}
        except (OSError, RuntimeError):
            seed = {"requests": 0, "shed": 0}
        with self._mu:
            self._replicas[server.replica] = server
            self._next_idx = max(self._next_idx, server.replica + 1)
            self._last_by[server.replica] = seed
            self._g_replicas.set(len(self._replicas))

    @property
    def replicas(self) -> Dict[int, InferenceServer]:
        with self._mu:
            return dict(self._replicas)

    def replica_count(self) -> int:
        with self._mu:
            return len(self._replicas)

    # -- observation -------------------------------------------------------
    def observe(self) -> dict:
        """Poll every replica's health() and diff PER REPLICA against
        its previous cumulative totals: {'requests', 'shed', 'rate',
        'replicas'}. A replica that cannot answer contributes nothing
        this window and keeps its last totals, so when it recovers the
        next diff covers only the gap — its lifetime counts never
        re-enter as a fake (scale-up-triggering) window."""
        d_req = 0
        d_shed = 0
        live = self.replicas
        for idx, srv in live.items():
            try:
                h = srv.health()
            except (OSError, RuntimeError):
                continue
            req = sum(h.get("requests", {}).values())
            shed = int(h.get("shed", 0))
            last = self._last_by.get(idx, {"requests": 0, "shed": 0})
            d_req += max(req - last["requests"], 0)
            d_shed += max(shed - last["shed"], 0)
            self._last_by[idx] = {"requests": req, "shed": shed}
        # drained/stopped replicas drop out of the bookkeeping
        for idx in list(self._last_by):
            if idx not in live:
                del self._last_by[idx]
        rate = (d_shed / d_req) if d_req > 0 else 0.0
        return {"requests": d_req, "shed": d_shed, "rate": rate,
                "replicas": self.replica_count()}

    # -- policy ------------------------------------------------------------
    def step(self) -> Optional[str]:
        """Evaluate one window; perform at most one scale action.
        Returns "up", "down", or None."""
        w = self.observe()
        if (w["shed"] > 0 and w["rate"] >= self.shed_rate_up
                and self.replica_count() < self.max_replicas):
            self._calm = 0
            self.scale_up()
            return "up"
        if w["shed"] == 0:
            self._calm += 1
            if (self.calm_windows_down > 0
                    and self._calm >= self.calm_windows_down
                    and self.replica_count() > self.min_replicas):
                self._calm = 0
                self.scale_down()
                return "down"
        else:
            self._calm = 0
        return None

    # -- actions -----------------------------------------------------------
    def scale_up(self) -> InferenceServer:
        """Start one more replica over the same bundle; registry
        discovery routes traffic to it within the clients'
        re-resolution TTL (no client restart)."""
        with self._mu:
            idx = self._next_idx
            self._next_idx += 1
        srv = InferenceServer(self.bundle, registry=self.registry,
                              service=self.service, shard=self.shard,
                              replica=idx, **self.server_kwargs)
        with self._mu:
            self._replicas[idx] = srv
            self._g_replicas.set(len(self._replicas))
        self._ctr_up.inc()
        return srv

    def scale_down(self, grace_s: float = 1.0) -> Optional[int]:
        """Drain the highest-index replica through the registry discovery
        path (deregister → grace → bounded queue drain → stop). Never
        goes below min_replicas. Returns the drained replica index."""
        with self._mu:
            if len(self._replicas) <= self.min_replicas:
                return None
            idx = max(self._replicas)
            srv = self._replicas.pop(idx)
            self._g_replicas.set(len(self._replicas))
        srv.drain(grace_s=grace_s)
        self._ctr_down.inc()
        return idx

    def close(self, drain: bool = False) -> None:
        """Stop every owned replica (drain=True routes each through the
        graceful path; False stops immediately — test teardown)."""
        for idx, srv in sorted(self.replicas.items(), reverse=True):
            with self._mu:
                self._replicas.pop(idx, None)
                self._g_replicas.set(len(self._replicas))
            if drain:
                srv.drain(grace_s=0.0)
            else:
                srv.stop()

    # -- loop convenience --------------------------------------------------
    def run(self, interval_s: float, stop_event: threading.Event) -> None:
        """Caller-owned cadence loop (bench/daemon): step every
        interval until the event fires."""
        while not stop_event.wait(interval_s):
            self.step()
