"""Deterministic fault injection for graph engines (chaos harness; copy
of euler_tpu/graph/chaos.py).

The reference's production value is that training survives a flaky
sharded graph service; none of that is testable without a way to MAKE
the service flaky on demand. ChaosGraphEngine wraps any engine-shaped
object (embedded GraphEngine, RemoteGraphEngine, DataSet.engine) and
injects a seeded, reproducible schedule of the faults a real cluster
shows:

  * transport errors  — EngineError with the same "failed after
    retries" shape a dead shard produces, so retry classification in
    RemoteGraphEngine / BaseEstimator treats them identically;
  * added latency     — fixed + jittered per-call sleeps (slow shard);
  * truncated results — every ndarray in the result loses the back
    half of its leading axis (a shard answering partially);
  * shard flaps       — periodic down-windows measured in calls, the
    kill/restart cycle as seen from the client.

Schedules are pure functions of (seed, call index): two engines built
from the same plan inject the same faults at the same calls, so a chaos
test is exactly reproducible. For faults below the API boundary (RST,
stalls, black-holes against the real framed-TCP stack) use
tools/chaos_proxy.py instead.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from typing import Tuple

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.core.lib import EngineError

_CHAOS_IDS = itertools.count()


@dataclasses.dataclass
class ChaosPlan:
    """Seeded fault schedule. Rates are per intercepted call; explicit
    schedules (fail_calls / fail_from / flap_*) are deterministic in the
    0-based call index and win over the probabilistic rates."""

    seed: int = 0
    error_rate: float = 0.0          # P(transport error) per call
    latency_ms: float = 0.0          # fixed added latency per call
    latency_jitter_ms: float = 0.0   # + U(0, jitter)
    truncate_rate: float = 0.0       # P(result arrays truncated)
    flap_period: int = 0             # calls per flap cycle (0 = off)
    flap_down: int = 0               # first N calls of each cycle fail
    fail_calls: Tuple[int, ...] = () # exact call indices that fail
    fail_from: int = -1              # all calls >= this index fail (<0 off)


class ChaosGraphEngine:
    """Engine wrapper injecting the plan's faults at the call boundary.

    Everything not listed in CHAOS_METHODS (properties, close, type_id,
    ...) passes straight through to the wrapped engine."""

    CHAOS_METHODS = frozenset({
        "sample_node", "sample_edge", "sample_node_with_types",
        "sample_neighbor", "sample_fanout", "sample_layerwise",
        "get_full_neighbor", "get_neighbor_edges", "random_walk",
        "get_dense_feature", "get_sparse_feature", "get_binary_feature",
        "get_edge_dense_feature", "get_edge_sparse_feature",
        "get_edge_binary_feature", "get_node_type", "get_top_k_neighbor",
        "all_node_ids",
    })

    def __init__(self, engine, plan: ChaosPlan):
        self._engine = engine
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._mu = threading.Lock()
        self._calls = 0
        self._counters = {"errors": 0, "delayed": 0, "truncated": 0}
        # mirror injected faults onto the obs registry so chaos tests
        # can assert fault injection and observability agree on counts
        # (chaos_injected_total{engine=...,kind=error|delay|truncate})
        self._obs_name = f"chaos{next(_CHAOS_IDS)}"
        injected = _obs.default_registry().counter(
            "chaos_injected_total",
            "faults injected by ChaosGraphEngine",
            ("engine", "kind"))
        self._obs_kind = {
            k: injected.labels(engine=self._obs_name, kind=k)
            for k in ("error", "delay", "truncate")}

    # -- schedule ----------------------------------------------------------
    def _decide(self, idx: int):
        """(fail, delay_s, truncate) for call `idx`. Consumes the seeded
        rng in a fixed per-call order so the schedule is a pure function
        of (seed, idx) regardless of which methods are called."""
        p = self.plan
        fail = (idx in p.fail_calls
                or (p.fail_from >= 0 and idx >= p.fail_from)
                or (p.flap_period > 0 and (idx % p.flap_period)
                    < p.flap_down))
        r_err = self._rng.random()
        r_trunc = self._rng.random()
        r_jit = self._rng.random()
        fail = fail or (p.error_rate > 0 and r_err < p.error_rate)
        trunc = p.truncate_rate > 0 and r_trunc < p.truncate_rate
        delay = 0.0
        if p.latency_ms > 0 or p.latency_jitter_ms > 0:
            delay = (p.latency_ms + r_jit * p.latency_jitter_ms) / 1000.0
        return fail, delay, trunc

    @staticmethod
    def _truncate(result):
        """Drop the back half of every ndarray's leading axis — the shape
        a partially-answering shard produces. Recurses through nested
        tuples/lists (sample_fanout returns a tuple of LISTS of per-hop
        arrays) so no result shape silently escapes truncation."""
        import numpy as np

        def cut(v):
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] > 1:
                return v[: v.shape[0] // 2]
            if isinstance(v, tuple):
                return tuple(cut(x) for x in v)
            if isinstance(v, list):
                return [cut(x) for x in v]
            return v

        return cut(result)

    # -- interception ------------------------------------------------------
    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if name not in self.CHAOS_METHODS or not callable(attr):
            return attr

        def chaotic(*args, **kwargs):
            with self._mu:
                idx = self._calls
                self._calls += 1
                fail, delay, trunc = self._decide(idx)
            if delay > 0:
                with self._mu:
                    self._counters["delayed"] += 1
                self._obs_kind["delay"].inc()
                time.sleep(delay)
            if fail:
                with self._mu:
                    self._counters["errors"] += 1
                self._obs_kind["error"].inc()
                raise EngineError(
                    f"chaos: rpc to shard failed after retries "
                    f"(injected at call {idx}, op {name})")
            out = attr(*args, **kwargs)
            if trunc:
                with self._mu:
                    self._counters["truncated"] += 1
                self._obs_kind["truncate"].inc()
                out = self._truncate(out)
            return out

        return chaotic

    # -- streaming deltas (explicit delegation) ----------------------------
    # The epoch/delta verbs are defined EXPLICITLY rather than left to
    # __getattr__: chaos interception must never apply to them (a fault-
    # injected apply_delta would diverge the wrapper's view of the epoch
    # from the engine's), and an engine lacking them must raise its own
    # AttributeError naming the engine — wrapper drift is pinned by
    # tests/test_streaming.py's delegation test.
    def graph_epoch(self, *args, **kwargs) -> int:
        return self._engine.graph_epoch(*args, **kwargs)

    def apply_delta(self, **delta) -> int:
        return self._engine.apply_delta(**delta)

    def delta_since(self, from_epoch: int):
        return self._engine.delta_since(from_epoch)

    # -- elastic fleet (explicit delegation, same contract as above) -------
    # Ownership-map maintenance is control-plane traffic: chaos must
    # never fault-inject a map refresh (a lost install would diverge
    # the wrapper's routing from the engine's).
    def refresh_ownership(self, force: bool = False) -> int:
        return self._engine.refresh_ownership(force=force)

    def ownership_epoch(self) -> int:
        return self._engine.ownership_epoch()

    def shard_traffic(self):
        return self._engine.shard_traffic()


    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        """Injected-fault counters: calls, errors, delayed, truncated."""
        with self._mu:
            return {"calls": self._calls, **self._counters}
