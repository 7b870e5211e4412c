"""The training loop: train / evaluate / train_and_evaluate, checkpoints,
the input path and its health counters (counterpart of
euler_tpu/estimator/base_estimator.py:108-235 config and obs wiring,
:238-333 the step, its nonfinite guard and the K-step loop, :343-408
checkpoints, :410-579 the resilient input path and the feeder,
:582-807 train, :809-843 evaluate, :932-1015 train_and_evaluate).

The reference jits one functional step over a flax TrainState; here the
state is the model's parameters, the optimizer's state, the global step
(a host int) and the guard's skip count (a device scalar). One step:

    forward (train mode, a dropout generator seeded from (seed+1, step))
    → loss.backward() → the guard → optimizer.step() → step += 1

The nonfinite guard skips the update when the loss or any gradient is
not finite: parameters and optimizer state stay as they were, the step
still advances and `skipped_steps` counts it — as the reference's
lax.cond does. The check stays on the device: the flag goes to the
optimizer as `found_inf` (utils/optimizers.py), so no step waits for
the host. The host reads the losses once, when `train` returns, and
every `log_steps` steps when it prints.

steps_per_loop = K > 1 is the reference's K-step lax.scan: every full
window of K batches runs as one replay of a CUDA graph of K steps
(estimator/graphed_loop.py); a tail shorter than K runs single steps.
On the CPU, which only a caller asks for, a window is K eager steps:
the same steps, with no graph.

The input path is the reference's: a transient failure (ConnectionError,
TimeoutError, any OSError) is retried with exponential backoff capped at
2 s (input_retries, input_backoff_s), then up to skip_batch_budget
batches are abandoned, then an emergency checkpoint is written and the
error re-raises. feeder_workers > 1 moves batches to the card in feeder
threads (estimator/prefetch.py). The counters live on the obs registry
(euler_tpu_torch.obs) with the reference's names and labels;
`input_health` and `health()` are views over them. profiling=True with
a model_dir traces each train call with torch.profiler into
model_dir/prof/.

Host batches reach the device as the reference's _to_device_tree
shapes them (euler_tpu/estimator/base_estimator.py:48-60): a uint64 id
array becomes int32 rows on the host before the copy, bucketized by
`% (max_id + 1)` when params["max_id"] > 0 (without it an id >= 2^31
wraps, as numpy's cast wraps it in the reference); `infer_ids` stay on
the host, which alone reads them.

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`).

mesh (parallel/mesh.py, one process per device): a step is
parallel.train.spmd_update, and parallel.train.splits_over_data decides
how a model takes the data axis. A split model trains each rank on its
data slice of every batch (mesh.data_slice, before the copy to the
device): the loss a mean over the global batch, the parameter gradients
summed over 'data' (one collective); evaluate() sums each batch's loss
and metric shares and mask count over 'data', and run_eval all-gathers
the embedding over it, so every rank sees the global batch's rows in
order. Any other model takes the whole batch on every data rank and
sums nothing over 'data', as the reference's estimator, which never
splits a batch, runs it. The nonfinite guard is decided for every rank.
The model's row-partitioned parameters keep this rank's rows
(sharded_embedding.apply_param_shardings) before the optimizer is
built. On the card a K-step window's collectives are captured in its
CUDA graph with the rest of the step. table_partition and
hub_cache_frac are the reference's partitioned-table options, validated
as there (callers building a PartitionedFeatureStore read them).

What a meshed estimator writes is the whole state, in the one-process
layout: a checkpoint gathers the row-sharded parameters and their
optimizer state (convert.gather_state_dict and
gather_optimizer_state_dict), `infer` the global batch's embeddings
and ids, `export_bundle` the whole parameters. World rank 0 alone
writes, then every rank passes a barrier; a restore loads the whole
file on every rank and keeps this rank's rows. So a checkpoint moves
between a mesh and one process both ways. The emergency checkpoint is
skipped on a mesh: one rank's input error is not seen by the others,
which a gather would wait for.
"""

from __future__ import annotations

import itertools
import os
import re
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch import obs as _obs
from euler_tpu_torch.estimator.graphed_loop import GraphedLoop
from euler_tpu_torch.estimator.infer import eval_mode, iter_embeddings
from euler_tpu_torch.estimator.prefetch import ParallelPrefetcher
from euler_tpu_torch.estimator.retry import retryable_error
from euler_tpu_torch.obs.device import PhaseRecorder
from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.mesh import data_slice
from euler_tpu_torch.parallel.train import (
    data_mesh, global_values, spmd_update,
)
from euler_tpu_torch.platform import (
    DeviceLike, host_to_device, resolve_device, seed_words,
)
from euler_tpu_torch.utils import optimizers as opt_lib

# per-process estimator numbering: the label value distinguishing N
# estimators' children on the shared estimator_* metrics
_EST_IDS = itertools.count()
KEEP_CHECKPOINTS = 3
_DROPOUT_WORD = 0xD0


def _to_device(batch: Dict[str, Any], device: torch.device,
               max_id: int = 0) -> Dict[str, Any]:
    """Tensors and numpy arrays onto the device, a uint64 id array as
    int32 rows (`% (max_id + 1)` first when max_id > 0); infer_ids and
    scalars stay as they are."""

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, non_blocking=True)
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint64:
                if max_id > 0:
                    v = v % np.uint64(max_id + 1)
                v = v.astype(np.int32)
            return host_to_device(v, device)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return {k: v if k == "infer_ids" else conv(v)
            for k, v in batch.items()}


def _nanmean(t: torch.Tensor) -> torch.Tensor:
    return torch.nanmean(t.float())


def _last_finite(vals: np.ndarray) -> float:
    """Most recent finite value (NaN when none): a guard-skipped step's
    NaN loss is not the run's loss."""
    finite = vals[np.isfinite(vals)]
    return float(finite[-1]) if finite.size else float("nan")


class BaseEstimator:
    """Trains a model with the ModelOutput contract on one device, or as
    this rank of a mesh (mesh=: its device, its data slice of every
    batch; see the module docstring).

    params (the reference's keys): optimizer ('adam'), learning_rate
    (0.01), weight_decay (0), seed (0: dropout draws from (seed+1,
    step)), log_steps (20), checkpoint_steps (1000; 0 = none),
    nonfinite_guard (True), steps_per_loop (1), input_retries (3),
    input_backoff_s (0.1), skip_batch_budget (0), feeder_workers (0),
    feeder_depth (0 = twice the workers), profiling (False), max_id (0:
    uint64 ids become int32 rows as they are; > 0: modulo max_id + 1),
    table_partition (0; >= 2 partitions the feature table) and
    hub_cache_frac (0.0, in [0, 1); needs table_partition >= 2).
    Checkpoints go to model_dir/checkpoints, the whole state on a mesh
    too (written by world rank 0; see the module docstring). The model's
    parameters are initialised by its constructor (from its generator),
    where the reference inits them from key(seed)."""

    def __init__(self, model: torch.nn.Module, params: Dict[str, Any],
                 model_dir: Optional[str] = None, device: DeviceLike = None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device).type \
                    != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            from euler_tpu_torch.parallel.sharded_embedding import (
                apply_param_shardings,
            )

            apply_param_shardings(model, mesh)
        else:
            self.device = resolve_device(device)
        self.params_cfg = dict(params or {})
        self._check_partition_options()
        self.model = model.to(self.device)
        self.model_dir = model_dir
        cfg = self.params_cfg
        self.optimizer = opt_lib.get(
            cfg.get("optimizer", "adam"), self.model.parameters(),
            float(cfg.get("learning_rate", 0.01)),
            weight_decay=float(cfg.get("weight_decay", 0.0)))
        self.seed = int(cfg.get("seed", 0))
        self.max_id = int(cfg.get("max_id", 0))
        self.log_steps = int(cfg.get("log_steps", 20))
        self.ckpt_steps = int(cfg.get("checkpoint_steps", 1000))
        self.nonfinite_guard = bool(cfg.get("nonfinite_guard", True))
        # > 1: full windows of K batches run as one CUDA graph replay
        self.steps_per_loop = int(cfg.get("steps_per_loop", 1))
        self.profiling = bool(cfg.get("profiling", False))
        # resilient input path: transient failures are retried with
        # backoff; past the retries up to skip_batch_budget batches may
        # be abandoned (counted); then an emergency checkpoint is
        # written and the error re-raises
        self.input_retries = int(cfg.get("input_retries", 3))
        self.input_backoff_s = float(cfg.get("input_backoff_s", 0.1))
        self._skip_budget = int(cfg.get("skip_batch_budget", 0))
        # feeder_workers > 1 wraps train()'s input in a
        # ParallelPrefetcher whose threads also move batches to the card
        self.feeder_workers = int(cfg.get("feeder_workers", 0))
        self.feeder_depth = int(cfg.get("feeder_depth", 0)) or None
        self._live_feeder = None
        self._input_factory = None
        self.step = 0
        self.skipped_steps = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
        self._one = torch.ones((), device=self.device)
        # device tensors merged into every batch (the tables)
        self.static_batch: Dict[str, Any] = {}
        # called with this estimator before every interleaved and final
        # evaluation of train_and_evaluate (e.g.
        # models.graphsage.refresh_act_cache)
        self.pre_eval_hook: Optional[Callable] = None
        self._restore_pending = True
        self._graphed = None  # graphed_loop.GraphedLoop, at the first window
        self._init_obs()

    def _check_partition_options(self) -> None:
        """The reference's validation of the partitioned-table options
        (euler_tpu/estimator/base_estimator.py:159-178)."""
        cfg = self.params_cfg
        self.table_partition = int(cfg.get("table_partition", 0))
        if self.table_partition < 0:
            raise ValueError(
                f"table_partition must be >= 0, got {self.table_partition}")
        self.hub_cache_frac = float(cfg.get("hub_cache_frac", 0.0))
        if not 0.0 <= self.hub_cache_frac < 1.0:
            raise ValueError(
                f"hub_cache_frac must be in [0, 1), got "
                f"{self.hub_cache_frac}")
        if self.hub_cache_frac > 0 and self.table_partition <= 1:
            raise ValueError(
                "hub_cache_frac needs a partitioned table "
                "(table_partition >= 2): a replicated table has no "
                "remote leg for the hub cache to absorb")

    def _init_obs(self) -> None:
        """The input-path counters, phase histograms and gauges on the obs
        registry, children labelled by this estimator (the reference's
        names); input_health and health() are views over them."""
        self._obs_name = f"estimator{next(_EST_IDS)}"
        reg = _obs.default_registry()
        lab = {"estimator": self._obs_name}

        def child(kind, name, help_):
            return getattr(reg, kind)(name, help_, ("estimator",)).labels(
                **lab)

        self._ctr_input_failures = child(
            "counter", "estimator_input_failures_total",
            "input batches that raised")
        self._ctr_input_retries = child(
            "counter", "estimator_input_retries_total",
            "input-pipeline retry sleeps")
        self._ctr_skipped_batches = child(
            "counter", "estimator_skipped_batches_total",
            "input batches abandoned under skip_batch_budget")
        self._hist_input_wait = child(
            "histogram", "estimator_input_wait_ms",
            "per-step host wait for the next batch (sampling + RPC + "
            "host→device conversion)")
        self._hist_device_step = child(
            "histogram", "estimator_device_step_ms",
            "per-step train-step dispatch")
        self._hist_hook = child(
            "histogram", "estimator_hook_ms",
            "per-step logging/checkpoint hooks")
        self._hist_replay_stage = child(
            "histogram", "estimator_replay_stage_ms",
            "per-replay host staging of a K-step window (static-input "
            "stacks, generator seeds)")
        self._hist_replay_launch = child(
            "histogram", "estimator_replay_launch_ms",
            "per-replay host time in CUDAGraph.replay()")
        phases = reg.histogram(
            "estimator_phase_device_ms",
            "per-step device time of an update's phases (obs/device.py)",
            ("estimator", "phase"))
        self._phases = PhaseRecorder(
            self.device, lambda p: phases.labels(phase=p, **lab))
        self._g_steps_per_sec = child(
            "gauge", "estimator_steps_per_sec", "train-loop throughput")
        self._g_skipped_steps = child(
            "gauge", "estimator_skipped_steps",
            "nonfinite-guard skipped device steps")
        self._g_global_step = child(
            "gauge", "estimator_global_step", "last reported global step")
        # one-shot markers stay on the instance; input_health merges them
        self._input_meta: Dict[str, Any] = {
            "emergency_checkpoint_step": None, "last_input_error": None}
        _obs.register_health(self._obs_name, self.health)

    # -- the step ----------------------------------------------------------
    @property
    def uses_dropout(self) -> bool:
        """Whether a training step needs a dropout generator: any of the
        model's modules with a `dropout` rate above 0 (the embedding's,
        SuperviseModel.dropout, or an encoder's or conv stack's input
        dropout)."""
        return any(getattr(m, "dropout", 0.0) > 0.0
                   for m in self.model.modules())

    def dropout_seed(self, step: int) -> int:
        # the last word keeps this stream apart from the sampling stream
        # (17, sample_seed) when seed + 1 == 17
        return seed_words(self.seed + 1, step, _DROPOUT_WORD)

    def _dropout_generator(self, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.dropout_seed(step))
        return g

    def _update(self, batch: Dict[str, Any]):
        """Forward, backward, the guard and the optimizer step on a batch
        merged with the tables (and, with dropout, its generator):
        parallel.train.spmd_update, whose collectives are no-ops without
        a mesh. Returns the (loss, metric) device scalars. Nothing here
        waits for the card or reads the host's step, so a CUDA graph can
        capture it."""
        with self._phases.update():
            loss, metric, found_inf = spmd_update(
                self.model, self.optimizer, batch, self.mesh,
                self.nonfinite_guard, self._one)
        if found_inf is not None:
            self.skipped_steps += found_inf.to(torch.int32)
        settle = getattr(self.model, "settle_cache_writes", None)
        if settle is not None:
            # the reference's extra_vars: a skipped step keeps the old
            # activation caches, as it keeps the old parameters
            settle(found_inf)
        return loss, metric

    def _train_step(self, batch: Dict[str, Any]):
        """One update from one batch (already on the device). Returns the
        (loss, metric) device scalars; nothing here waits for the card."""
        batch = {**batch, **self.static_batch}
        if self.uses_dropout:
            batch["dropout_generator"] = self._dropout_generator(self.step)
        loss, metric = self._update(batch)
        self.step += 1
        return loss, metric

    def _train_window(self, batches: List[Dict[str, Any]]):
        """K steps on K batches: one replay of the K-step CUDA graph on
        the card, K eager steps on the CPU. Returns (losses [K], metrics
        [K])."""
        if self.device.type == "cuda":
            if self._graphed is None:
                self._graphed = GraphedLoop(self.device, self.steps_per_loop)
            return self._graphed.run(self, batches)
        outs = [self._train_step(b) for b in batches]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def _to_device(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch on the device: this rank's data slice of it for
        a model that splits over the mesh's data axis (mesh.data_slice),
        the whole batch otherwise, then _to_device."""
        dmesh = data_mesh(self.model, self.mesh)
        if dmesh is not None:
            raw = data_slice(raw, dmesh)
        return _to_device(raw, self.device, self.max_id)

    def _writes_files(self) -> bool:
        """Whether this process writes what the estimator saves: world
        rank 0 on a mesh, always without one."""
        return self.mesh is None or dist.get_rank() == 0

    def _barrier(self) -> None:
        """On a mesh: every rank waits until world rank 0 has written."""
        if self.mesh is not None:
            dist.barrier()

    def _maybe_restore(self) -> None:
        # the reference restores when it first builds its state
        if self._restore_pending:
            self._restore_pending = False
            self.restore_checkpoint()

    # -- checkpoints -------------------------------------------------------
    def _checkpoint_dir(self) -> Optional[str]:
        if not self.model_dir:
            return None
        return os.path.join(os.path.abspath(self.model_dir), "checkpoints")

    def _checkpoints(self) -> List[tuple]:
        d = self._checkpoint_dir()
        if d is None or not os.path.isdir(d):
            return []
        found = []
        for name in os.listdir(d):
            m = re.fullmatch(r"ckpt-(\d+)\.pt", name)
            if m:
                found.append((int(m.group(1)), os.path.join(d, name)))
        return sorted(found)

    def save_checkpoint(self, step: int) -> None:
        """{model, optimizer, step, skipped_steps} as
        model_dir/checkpoints/ckpt-<step>.pt, on the CPU; the last 3 are
        kept. The model's state_dict holds its activation caches (the
        reference's extra_vars) beside its parameters. On a mesh every
        rank joins the gather of the whole state and world rank 0 alone
        writes it, in the one-process layout; then every rank passes a
        barrier."""
        from euler_tpu_torch.convert import (
            gather_optimizer_state_dict, gather_state_dict,
        )

        d = self._checkpoint_dir()
        if d is None:
            return
        payload = {"model": gather_state_dict(self.model),
                   "optimizer": gather_optimizer_state_dict(self.optimizer),
                   "step": int(step),
                   "skipped_steps": int(self.skipped_steps)}
        if self._writes_files():
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"ckpt-{int(step)}.pt")
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)  # a reader never sees a partial file
            for _, old in self._checkpoints()[:-KEEP_CHECKPOINTS]:
                os.remove(old)
        self._barrier()

    def restore_checkpoint(self) -> Optional[int]:
        """Load the latest checkpoint and resume at its step; None when
        there is none. Every rank of a mesh loads the whole file and
        keeps its rows of each row-sharded tensor. The optimizer's state
        tensors are replaced, so a captured K-step graph is dropped and
        captured again."""
        from euler_tpu_torch.convert import (
            shard_optimizer_state_dict, shard_state_dict,
        )

        found = self._checkpoints()
        if not found:
            return None
        payload = torch.load(found[-1][1], map_location="cpu",
                             weights_only=True)
        self.model.load_state_dict(
            shard_state_dict(payload["model"], self.model))
        self.optimizer.load_state_dict(shard_optimizer_state_dict(
            payload["optimizer"], self.optimizer))
        if self._graphed is not None:
            self._graphed.invalidate()
        self.step = int(payload["step"])
        self.skipped_steps.fill_(int(payload["skipped_steps"]))
        self._restore_pending = False
        return self.step

    # -- resilient input path ----------------------------------------------
    @property
    def input_health(self) -> Dict[str, Any]:
        """Input-path counters: a view over this estimator's obs registry
        children plus the last-error and emergency-checkpoint markers."""
        return {
            "input_failures": int(self._ctr_input_failures.value),
            "input_retries": int(self._ctr_input_retries.value),
            "skipped_batches": int(self._ctr_skipped_batches.value),
            **self._input_meta,
        }

    def health(self) -> Dict[str, Any]:
        """input_health plus the nonfinite guard's skip count, merged with
        the graph client's health() when the estimator's graph has one
        (euler_tpu/estimator/base_estimator.py:443-445), and with the
        feature store's cache_stats() (a PartitionedFeatureStore's degree
        stats, hub-cache hits and gather legs) as "feature_store". The
        count comes from the obs gauge, which the train thread refreshes
        at every log and when train() returns: health() may run on
        another thread (/healthz) and must not wait for the card."""
        out = dict(self.input_health)
        out["skipped_steps"] = int(self._g_skipped_steps.value)
        graph_health = getattr(getattr(self, "graph", None), "health", None)
        if callable(graph_health):
            out["graph"] = graph_health()
        store_stats = getattr(getattr(self, "feature_store", None),
                              "cache_stats", None)
        if callable(store_stats):
            out["feature_store"] = store_stats()
        return out

    def _phase(self, name: str, hist):
        """Span + histogram for one train-loop phase (input_wait /
        device_step / hook); exceptions, StopIteration included, pass
        through."""
        return _obs.timed_span(name, hist, estimator=self._obs_name)

    def _emergency_checkpoint(self, err: BaseException) -> None:
        """Best-effort checkpoint before an unrecoverable input error
        re-raises: the run dies, the progress doesn't. Never masks the
        original error. Nothing is saved before the first batch of the
        first train() has arrived (no state yet: nothing trained and no
        checkpoint restored), as the reference saves nothing while its
        state is None."""
        if self._restore_pending:
            return
        if self.mesh is not None:
            # saving gathers over the mesh, and the other ranks may
            # never see this rank's error: the gather would hang
            self._input_meta["emergency_checkpoint_skipped"] = (
                "no emergency checkpoint on a mesh: one rank's input "
                "error is not seen by the other ranks, whose gather of "
                "the state it would wait for")
            return
        step = self.step
        try:
            self.save_checkpoint(step)
            if self.model_dir:
                self._input_meta["emergency_checkpoint_step"] = step
                print(f"emergency checkpoint at step {step} before "
                      f"re-raising input error: {err}", flush=True)
        except Exception as ce:  # disk full etc.
            print(f"emergency checkpoint failed ({ce}); "
                  f"re-raising original input error", flush=True)

    # -- multi-worker feeder -----------------------------------------------
    def _train_batch_factory(self):
        """Thread-safe zero-arg one-batch callable for the multi-worker
        feeder, or None when the input stream must stay serialized
        (subclass hook — see NodeEstimator)."""
        return None

    def _wrap_feeder(self, input_fn, use_factory: bool = True):
        """ParallelPrefetcher over the train input, its workers moving
        each batch to the card: the subclass batch factory when one
        exists AND the caller passed the estimator's own train_input_fn;
        a custom input_fn's stream is never substituted — it wraps with
        serialized next() so its schedule is kept."""
        src = self._train_batch_factory() if use_factory else None
        if src is None:
            src = input_fn() if callable(input_fn) else input_fn
        f = ParallelPrefetcher(
            src, workers=self.feeder_workers, depth=self.feeder_depth,
            transform=self._to_device,
            name=f"{self._obs_name}_train")
        self._live_feeder = f
        return f

    def _close_live_feeder(self) -> None:
        f, self._live_feeder = self._live_feeder, None
        if f is not None:
            f.close()

    def _next_input(self, it):
        """next(it) with transient-failure retry (exponential backoff)
        and the skip-batch budget. Returns (raw_batch, it): the iterator
        may have been recreated from the train input_fn after a failure
        (a generator that raised is dead). StopIteration passes through;
        an unrecoverable error checkpoints, then re-raises.

        Retry and skip assume input_fn() gives a stateless (infinite
        random-sampler) stream, as every built-in input_fn does, since
        recreation restarts the stream. Without a factory (a plain
        iterator) every failure is unrecoverable, unless the iterator is
        a resilient feeder, which survives its own errors."""
        attempts = 0
        while True:
            try:
                return next(it), it
            except StopIteration:
                raise
            except Exception as e:
                transient = ((self._input_factory is not None
                              or getattr(it, "resilient", False))
                             and (retryable_error(e)
                                  or isinstance(e, OSError)))
                self._ctr_input_failures.inc()
                self._input_meta["last_input_error"] = str(e)
                if not transient:
                    self._emergency_checkpoint(e)
                    raise
                if attempts < self.input_retries:
                    attempts += 1
                    self._ctr_input_retries.inc()
                    with _obs.span("input_retry_backoff",
                                   estimator=self._obs_name,
                                   attempt=attempts):
                        time.sleep(min(
                            self.input_backoff_s * (2 ** (attempts - 1)),
                            2.0))
                elif self._skip_budget > 0:
                    # retries exhausted for this batch: abandon it and
                    # move on (a counted degraded event, not a job kill)
                    self._skip_budget -= 1
                    self._ctr_skipped_batches.inc()
                    attempts = 0
                else:
                    self._emergency_checkpoint(e)
                    raise
                if self._input_factory is not None and not getattr(
                        it, "resilient", False):
                    # the raised iterator is dead: close it (a feeder
                    # holds threads) and recreate it. A resilient
                    # feeder delivers the error in-stream and goes on.
                    closer = getattr(it, "close", None)
                    if callable(closer):
                        try:
                            closer()
                        except Exception:
                            pass
                    it = self._input_factory()

    def _next_batch(self, it):
        """The next batch on the device, timed as input_wait."""
        with self._phase("input_wait", self._hist_input_wait):
            raw, it = self._next_input(it)
            return self._to_device(raw), it

    # -- entry points ------------------------------------------------------
    def train(self, input_fn: Callable[[], Iterator[Dict]],
              max_steps: int = 1000) -> Dict[str, Any]:
        """Steps until the global step reaches max_steps or the input
        ends. input_fn: a callable giving an iterator (recreated after an
        input failure), or the iterator itself (then train takes only the
        batches it steps on, so one iterator can feed several calls). The
        returned dict also holds `losses`, this call's per-step losses,
        and `skipped_batches`, the batches the input path abandoned."""
        own_feeder = self.feeder_workers > 1 and callable(input_fn)
        if own_feeder:
            # the feeder owns threads: train() reclaims it on every exit
            # path, and recreation after a failure rebuilds it
            use_factory = input_fn == getattr(self, "train_input_fn", None)
            it = self._wrap_feeder(input_fn, use_factory)
            self._input_factory = lambda: self._wrap_feeder(input_fn,
                                                            use_factory)
        else:
            it = input_fn() if callable(input_fn) else input_fn
            self._input_factory = input_fn if callable(input_fn) else None
        try:
            return self._train_impl(it, max_steps)
        finally:
            # the factory may hold this estimator (a bound train_input_fn):
            # drop it so the estimator, and its graph's memory, is freed
            # by reference counting
            self._input_factory = None
            if own_feeder:
                self._close_live_feeder()

    def _train_impl(self, it, max_steps: int) -> Dict[str, Any]:
        batch, it = self._next_batch(it)
        self._maybe_restore()
        self.model.train()
        start_step = self.step
        prof = self._start_profiler()
        t0 = time.monotonic()
        try:
            if self.steps_per_loop > 1:
                entries = self._run_looped(it, batch, max_steps)
            else:
                entries = self._run_single(it, batch, max_steps)
        finally:
            self._stop_profiler(prof, start_step)
        step = self.step
        if self.ckpt_steps:
            self.save_checkpoint(step)
        # (loss, metric, weight): a step has weight 1, a K-step window
        # its nan-means and weight K, as the reference weights its
        # windows; NaN entries (guard-skipped steps) drop out
        losses = (torch.cat([e[0] for e in entries]).cpu().numpy()
                  if entries else np.zeros(0, np.float32))
        metrics = (torch.stack([_nanmean(e[1]) for e in entries])
                   .cpu().double().numpy() if entries else np.zeros(0))
        self._phases.collect()
        w = np.asarray([e[1].numel() for e in entries], np.float64)
        keep = np.isfinite(metrics)
        if not entries:
            metric = 0.0
        elif keep.any():
            metric = float(np.dot(metrics[keep], w[keep] / w[keep].sum()))
        else:
            metric = float("nan")
        rate = (step - start_step) / max(time.monotonic() - t0, 1e-9)
        skipped = int(self.skipped_steps)
        self._g_steps_per_sec.set(rate)
        self._g_skipped_steps.set(skipped)
        self._g_global_step.set(step)
        return {
            "loss": _last_finite(losses),
            "metric": metric,
            "steps_per_sec": rate,
            "global_step": step,
            "skipped_steps": skipped,
            "skipped_batches": self.input_health["skipped_batches"],
            "losses": losses.tolist(),
        }

    def _run_single(self, it, batch, max_steps: int) -> List[tuple]:
        """One step per batch; logs when the step is a multiple of
        log_steps, checkpoints at multiples of checkpoint_steps."""
        step = self.step
        entries: List[tuple] = []
        last_log = time.monotonic()
        while step < max_steps:
            with _obs.span("train_step", estimator=self._obs_name,
                           step=step):
                with self._phase("device_step", self._hist_device_step):
                    loss, metric = self._train_step(batch)
                step = self.step
                entries.append((loss.reshape(1), metric.reshape(1)))
                do_log = step % self.log_steps == 0
                do_ckpt = self.ckpt_steps and step % self.ckpt_steps == 0
                if do_log or do_ckpt:
                    with self._phase("hook", self._hist_hook):
                        if do_log:
                            window = entries[-self.log_steps:]
                            last_log = self._log(
                                step, torch.cat([e[0] for e in window]),
                                torch.cat([e[1] for e in window]),
                                self.log_steps, last_log)
                        if do_ckpt:
                            self.save_checkpoint(step)
                if step < max_steps:
                    try:
                        batch, it = self._next_batch(it)
                    except StopIteration:
                        break
        return entries

    def _run_looped(self, it, first, max_steps: int) -> List[tuple]:
        """steps_per_loop > 1: each full window of K batches runs as one
        _train_window; a tail shorter than K runs single steps. Logs when
        log_steps steps have passed since the last log, checkpoints when
        a window crosses a multiple of checkpoint_steps."""
        K = self.steps_per_loop
        step = logged_at = self.step
        entries: List[tuple] = []
        last_log = time.monotonic()
        buf = [first]
        exhausted = False
        while step < max_steps:
            with _obs.span("train_window", estimator=self._obs_name,
                           step=step):
                want = min(K, max_steps - step)
                if len(buf) < want and not exhausted:
                    with self._phase("input_wait", self._hist_input_wait):
                        while len(buf) < want and not exhausted:
                            try:
                                raw, it = self._next_input(it)
                                buf.append(self._to_device(raw))
                            except StopIteration:
                                exhausted = True
                if not buf:
                    break
                if len(buf) == K:
                    with self._phase("device_step", self._hist_device_step):
                        entries.append(self._train_window(buf))
                else:
                    for b in buf:
                        with self._phase("device_step",
                                         self._hist_device_step):
                            loss, metric = self._train_step(b)
                        entries.append((loss.reshape(1), metric.reshape(1)))
                prev, step, buf = step, self.step, []
                do_log = step - logged_at >= self.log_steps
                do_ckpt = self.ckpt_steps and \
                    step // self.ckpt_steps > prev // self.ckpt_steps
                if do_log or do_ckpt:
                    with self._phase("hook", self._hist_hook):
                        if do_log:
                            last_log = self._log(step, *entries[-1],
                                                 step - logged_at, last_log)
                            logged_at = step
                        if do_ckpt:
                            self.save_checkpoint(step)
                if exhausted:
                    break
        return entries

    def _log(self, step: int, losses: torch.Tensor, metrics: torch.Tensor,
             steps: int, last_log: float) -> float:
        """Print the nan-means of the window's losses and metrics and the
        rate since the last log; refresh the gauges health() reads (the
        train thread owns the device state here). Returns the time."""
        now = time.monotonic()
        rate = steps / max(now - last_log, 1e-9)
        self._g_steps_per_sec.set(rate)
        self._g_skipped_steps.set(int(self.skipped_steps))
        print(f"step {step}: loss={float(_nanmean(losses)):.4f} "
              f"metric={float(_nanmean(metrics)):.4f} "
              f"({rate:.1f} steps/s)", flush=True)
        # the losses' read waited for the card: the marks are complete
        self._phases.collect()
        return now

    def _start_profiler(self):
        """profiling=True with a model_dir: torch.profiler over the train
        call (the counterpart of jax.profiler.start_trace), over every
        thread where torch can (profile_all_threads), so the feeder's
        obs spans are ranges in the trace beside the loop's."""
        if not (self.profiling and self.model_dir):
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw = {"experimental_config":
                  _ExperimentalConfig(profile_all_threads=True)}
        except (ImportError, TypeError):
            kw = {}
        prof = profile(activities=acts, **kw)
        prof.start()
        return prof

    def _stop_profiler(self, prof, start_step: int) -> None:
        """Stop the trace and write it as model_dir/prof/
        trace-<first step>-<last step>.json (chrome trace format), on a
        mesh trace-<first>-<last>-rank<world rank>.json: each rank
        traces its own process."""
        if prof is None:
            return
        prof.stop()
        d = os.path.join(os.path.abspath(self.model_dir), "prof")
        os.makedirs(d, exist_ok=True)
        name = f"trace-{start_step}-{self.step}"
        if self.mesh is not None:
            name += f"-rank{dist.get_rank()}"
        prof.export_chrome_trace(os.path.join(d, f"{name}.json"))

    def evaluate(self, input_fn, steps: int = 100) -> Dict[str, float]:
        """Mean loss and metric over up to `steps` batches, each batch
        weighted by the sum of its graph_mask, else of its metric_mask,
        else by 1, as the reference weights them
        (euler_tpu/estimator/base_estimator.py:829-835): a short final
        batch of a sweep counts for its real entries only."""
        it = input_fn() if callable(input_fn) else input_fn
        self._maybe_restore()
        dmesh = data_mesh(self.model, self.mesh)
        rows = []
        with eval_mode(self.model), torch.inference_mode():
            for _ in range(steps):
                try:
                    batch = self._to_device(next(it))
                except StopIteration:
                    break
                with collectives.data_parallel(dmesh):
                    out = self.model({**batch, **self.static_batch})
                mask = batch.get("graph_mask")
                if mask is None:
                    mask = batch.get("metric_mask")
                w = (torch.ones((), device=self.device) if mask is None
                     else mask.to(torch.float32).sum())
                # on a data axis the batch splits over: the loss's and
                # the metric's shares and the mask's count summed over
                # it, the global batch's
                rows.append(global_values(torch.stack(
                    [out.loss.float(), out.metric.float(), w]), dmesh))
        if not rows:
            return {"loss": float("nan"), "metric": float("nan")}
        losses, metrics, w = torch.stack(rows).cpu().double().numpy().T
        w = w / w.sum()
        return {"loss": float(np.dot(losses, w)),
                "metric": float(np.dot(metrics, w))}

    def run_eval(self, batch: Dict[str, Any]):
        """One forward in eval mode (no dropout, no autograd) of a batch
        moved to the device and merged with the tables. Its embedding
        holds the global batch's rows in order on every rank: a split
        model's rank slices are all-gathered over 'data' (a replicated
        model computes the whole batch's)."""
        dmesh = data_mesh(self.model, self.mesh)
        with eval_mode(self.model), torch.inference_mode(), \
                collectives.data_parallel(dmesh):
            out = self.model({**self._to_device(batch),
                              **self.static_batch})
        if dmesh is not None and dmesh.size("data") > 1:
            out = out._replace(embedding=collectives.all_gather(
                out.embedding, dmesh.group("data")))
        return out

    def infer(self, input_fn, steps: int = 100,
              id_key: str = "infer_ids") -> Dict[str, str]:
        """Writes embedding_0.npy / ids_0.npy under model_dir (every
        batch's rows, pad rows included, as the reference writes them:
        euler_tpu/estimator/base_estimator.py:844-877). On a mesh every
        rank runs the sweep and world rank 0 writes the global batches'
        rows, then every rank passes a barrier."""
        it = input_fn() if callable(input_fn) else input_fn
        self._maybe_restore()
        embs, ids = [], []
        for v, emb in iter_embeddings(self.run_eval,
                                      itertools.islice(it, steps), id_key):
            embs.append(emb.cpu().numpy())
            if v is not None:
                ids.append(v)
        out_dir = self.model_dir or "."
        emb_path = os.path.join(out_dir, "embedding_0.npy")
        id_path = os.path.join(out_dir, "ids_0.npy")
        if self._writes_files():
            os.makedirs(out_dir, exist_ok=True)
            np.save(emb_path,
                    np.concatenate(embs) if embs else np.zeros((0,)))
            if ids:
                np.save(id_path, np.concatenate(ids))
        self._barrier()
        return {"embedding": emb_path, "ids": id_path}

    def export_bundle(self, out_dir: str, input_fn=None,
                      steps: int = 1_000_000, nlist: int = 64,
                      nprobe: int = 8, index: bool = True,
                      shards: int = 1, version: Optional[str] = None,
                      extra_meta: Optional[Dict[str, Any]] = None):
        """Export a versioned serving bundle (euler_tpu_torch.serving;
        the reference's files, euler_tpu/estimator/base_estimator.py:
        879-930): the parameters under the reference's flax tree paths
        (Dense kernels [in, out], convert.state_dict_to_flax), the
        node-embedding matrix from an `embed_all` pass over `input_fn`
        (default: this estimator's infer_input_fn sweep), and an IVFFlat
        index over it (only unsharded, with >= 2 ids). `shards > 1`
        writes the partitioned fleet layout instead; `version` stamps
        the bundle_version the hot-swap protocol reports (default: the
        training step). The model spec is the model's `export_spec()`:
        the reference model's class name and its scalar fields. Returns
        the ModelBundle (already written to out_dir). On a mesh the
        parameters are the whole ones (convert.gather_state_dict), every
        rank builds the same bundle and world rank 0 writes it, then
        every rank passes a barrier."""
        from euler_tpu_torch.convert import (
            flax_param_paths, gather_state_dict,
        )
        from euler_tpu_torch.serving.export import ModelBundle, embed_all
        from euler_tpu_torch.tools.knn import IVFFlatIndex

        ids, emb = embed_all(self, input_fn, steps)
        params = flax_param_paths(gather_state_dict(self.model))
        spec = self.model.export_spec() if hasattr(
            self.model, "export_spec") else {
            "model_class": type(self.model).__name__}
        meta = {"global_step": int(self.step), **(extra_meta or {})}
        if version is not None:
            meta["bundle_version"] = str(version)
        index_state = None
        if index and shards == 1 and len(ids) >= 2:
            # the global index only serves the unsharded layout;
            # save_sharded trains one per shard instead
            idx = IVFFlatIndex(nlist=nlist, nprobe=nprobe)
            idx.train_add(emb, ids)
            index_state = idx.state_dict()
        bundle = ModelBundle(params, emb, ids, index_state, spec, meta)
        if self._writes_files():
            if shards > 1:
                bundle.save_sharded(out_dir, shards, nlist=nlist,
                                    nprobe=nprobe, index=index)
            else:
                bundle.save(out_dir)
        self._barrier()
        return bundle

    def train_and_evaluate(self, train_input_fn, eval_input_fn,
                           max_steps: int = 1000, eval_steps: int = 50,
                           eval_every: int = 0,
                           keep_best: bool = False) -> Dict[str, Any]:
        """Train, evaluating every `eval_every` steps (0: once at the
        end). keep_best snapshots the parameters and buffers (the
        activation caches) at the best interleaved eval metric and
        restores them before the final evaluation. pre_eval_hook runs
        before each evaluation, as the reference runs it."""
        if eval_every <= 0:
            train_res = self.train(train_input_fn, max_steps)
            if self.pre_eval_hook:
                self.pre_eval_hook(self)
            eval_res = self.evaluate(eval_input_fn, eval_steps)
            return {**{f"train_{k}": v for k, v in train_res.items()},
                    **{f"eval_{k}": v for k, v in eval_res.items()}}
        owned_feeder = self.feeder_workers > 1 and callable(train_input_fn)
        if owned_feeder:
            # one feeder spans every segment (segments pass it as a bare
            # iterator, so train() neither wraps nor closes it)
            it = self._wrap_feeder(
                train_input_fn,
                train_input_fn == getattr(self, "train_input_fn", None))
        else:
            it = train_input_fn() if callable(train_input_fn) \
                else train_input_fn
        best_metric, best_step, best_snap = -float("inf"), 0, None
        train_res: Dict[str, Any] = {}
        step = 0
        # segments checkpoint once at the end (at the restored-best
        # weights), not once per segment
        saved_ckpt_steps, self.ckpt_steps = self.ckpt_steps, 0
        try:
            while step < max_steps:
                target = min(step + eval_every, max_steps)
                try:
                    seg = self.train(it, max_steps=target)
                except StopIteration:
                    break  # train iterator exhausted at a segment edge
                train_res = seg
                step = seg["global_step"]
                if self.pre_eval_hook:
                    self.pre_eval_hook(self)
                m = self.evaluate(eval_input_fn, eval_steps)["metric"]
                if keep_best and (best_snap is None or m > best_metric):
                    best_metric, best_step = m, step
                    best_snap = {k: v.detach().clone() for k, v in
                                 self.model.state_dict().items()}
                if step < target:
                    break  # train iterator exhausted mid-segment
        finally:
            self.ckpt_steps = saved_ckpt_steps
            if owned_feeder:
                self._close_live_feeder()
        if keep_best and best_snap is not None:
            self.model.load_state_dict(best_snap)
        if self.ckpt_steps:
            self.save_checkpoint(step)  # disk matches the reported weights
        if self.pre_eval_hook:
            # a restored-best snapshot's caches were refreshed before its
            # evaluation; keep_best=False reaches here without a refresh
            self.pre_eval_hook(self)
        eval_res = self.evaluate(eval_input_fn, eval_steps)
        out = {**{f"train_{k}": v for k, v in train_res.items()},
               **{f"eval_{k}": v for k, v in eval_res.items()}}
        if keep_best:
            out["best_step"] = best_step
        return out
