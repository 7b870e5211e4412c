"""The training loop: train / evaluate / train_and_evaluate and checkpoints
(counterpart of euler_tpu/estimator/base_estimator.py:108-127 config,
:238-300 the step and its nonfinite guard, :343-408 checkpoints,
:582-692 train, :809-843 evaluate, :932-1015 train_and_evaluate).

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

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`). Options the reference has and the port does not yet
(steps_per_loop > 1, the multi-worker feeder, input retries, the obs
counters, the partitioned table tier, id bucketization, the profiling
hook) raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from euler_tpu_torch.estimator.infer import eval_mode
from euler_tpu_torch.platform import (
    DeviceLike, host_to_device, resolve_device, seeded_generator,
)
from euler_tpu_torch.utils import optimizers as opt_lib

_ROADMAP_LOOP = "ROADMAP.md Queue A, 'Training: steps_per_loop'"
_ROADMAP_INPUT = "ROADMAP.md Queue A, 'Training: input pipeline and obs'"
_ROADMAP_MULTI = "ROADMAP.md Queue A, 'Multi-GPU'"
_ROADMAP_ENGINE = "ROADMAP.md Queue A, 'Engine binding'"

# reference option → (the values that mean what the port does, its
# ROADMAP item); any other value raises
_UNPORTED = {
    "steps_per_loop": ((1,), _ROADMAP_LOOP),
    "feeder_workers": ((0, 1), _ROADMAP_INPUT),
    "feeder_depth": ((0,), _ROADMAP_INPUT),
    "input_retries": ((0,), _ROADMAP_INPUT),
    "input_backoff_s": ((0,), _ROADMAP_INPUT),
    "skip_batch_budget": ((0,), _ROADMAP_INPUT),
    "profiling": ((False,), _ROADMAP_INPUT),
    "table_partition": ((0, 1), _ROADMAP_MULTI),
    "hub_cache_frac": ((0,), _ROADMAP_MULTI),
    "max_id": ((0,), _ROADMAP_ENGINE),
}
KEEP_CHECKPOINTS = 3
_DROPOUT_WORD = 0xD0


def _refuse_unported(cfg: Dict[str, Any]) -> None:
    for key, (same, item) in _UNPORTED.items():
        if key in cfg and cfg[key] not in same:
            raise NotImplementedError(
                f"{key}={cfg[key]!r} is not ported yet: {item}")


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Tensors and numpy arrays onto the device; uint64 id arrays
    (host-only, e.g. infer_ids) and scalars stay as they are."""

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, non_blocking=True)
        if isinstance(v, np.ndarray) and v.dtype != np.uint64:
            return host_to_device(v, device)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return {k: conv(v) for k, v in batch.items()}


def _last_finite(vals: np.ndarray) -> float:
    """Most recent finite value (NaN when none): a guard-skipped step's
    NaN loss is not the run's loss."""
    finite = vals[np.isfinite(vals)]
    return float(finite[-1]) if finite.size else float("nan")


class BaseEstimator:
    """Trains a model with the ModelOutput contract on one device.

    params (the reference's keys): optimizer ('adam'), learning_rate
    (0.01), weight_decay (0), seed (0: dropout draws from (seed+1,
    step)), log_steps (20), checkpoint_steps (1000; 0 = none),
    nonfinite_guard (True). Checkpoints go to model_dir/checkpoints.
    The model's parameters are initialised by its constructor (from its
    generator), where the reference inits them from key(seed)."""

    def __init__(self, model: torch.nn.Module, params: Dict[str, Any],
                 model_dir: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params_cfg = dict(params or {})
        _refuse_unported(self.params_cfg)
        self.model = model.to(self.device)
        self.model_dir = model_dir
        cfg = self.params_cfg
        self.optimizer = opt_lib.get(
            cfg.get("optimizer", "adam"), self.model.parameters(),
            float(cfg.get("learning_rate", 0.01)),
            weight_decay=float(cfg.get("weight_decay", 0.0)))
        self.seed = int(cfg.get("seed", 0))
        self.log_steps = int(cfg.get("log_steps", 20))
        self.ckpt_steps = int(cfg.get("checkpoint_steps", 1000))
        self.nonfinite_guard = bool(cfg.get("nonfinite_guard", True))
        self.step = 0
        self.skipped_steps = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
        self._one = torch.ones((), device=self.device)
        # device tensors merged into every batch (the tables)
        self.static_batch: Dict[str, Any] = {}
        self._restore_pending = True

    # -- the step ----------------------------------------------------------
    def _dropout_generator(self, step: int) -> torch.Generator:
        # the last word keeps this stream apart from the sampling stream
        # (17, sample_seed) when seed + 1 == 17
        return seeded_generator(self.device, self.seed + 1, step,
                                _DROPOUT_WORD)

    def _train_step(self, batch: Dict[str, Any]):
        """One update from one batch (already on the device). Returns the
        (loss, metric) device scalars; nothing here waits for the card."""
        batch = {**batch, **self.static_batch}
        if getattr(self.model, "dropout", 0.0) > 0.0:
            batch["dropout_generator"] = self._dropout_generator(self.step)
        out = self.model(batch)
        self.optimizer.zero_grad(set_to_none=True)
        out.loss.backward()
        loss = out.loss.detach()
        if self.nonfinite_guard:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            found_inf = (~torch.isfinite(loss)).to(torch.float32)
            # GradScaler's check: one multi-tensor pass over the grads
            # sets found_inf to 1 on a NaN or Inf (and scales by 1)
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found_inf, self._one)
            self.optimizer.found_inf = found_inf
            self.optimizer.step()
            self.skipped_steps += found_inf.to(torch.int32)
        else:
            self.optimizer.step()
        self.step += 1
        return loss, out.metric.detach()

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
        model_dir/checkpoints/ckpt-<step>.pt; the last 3 are kept."""
        d = self._checkpoint_dir()
        if d is None:
            return
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"ckpt-{int(step)}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": int(step),
                    "skipped_steps": int(self.skipped_steps)}, tmp)
        os.replace(tmp, path)  # a reader never sees a partial file
        for _, old in self._checkpoints()[:-KEEP_CHECKPOINTS]:
            os.remove(old)

    def restore_checkpoint(self) -> Optional[int]:
        """Load the latest checkpoint and resume at its step; None when
        there is none."""
        found = self._checkpoints()
        if not found:
            return None
        payload = torch.load(found[-1][1], map_location=self.device,
                             weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        self.skipped_steps.fill_(int(payload["skipped_steps"]))
        self._restore_pending = False
        return self.step

    # -- entry points ------------------------------------------------------
    def train(self, input_fn: Callable[[], Iterator[Dict]],
              max_steps: int = 1000) -> Dict[str, Any]:
        """Steps until the global step reaches max_steps or the input
        ends. input_fn: a callable giving an iterator, or the iterator
        itself (then train takes only the batches it steps on, so one
        iterator can feed several calls). The returned dict also holds
        `losses`, this call's per-step losses."""
        it = input_fn() if callable(input_fn) else input_fn
        batch = _to_device(next(it), self.device)
        self._maybe_restore()
        self.model.train()
        step = start_step = self.step
        losses: List[torch.Tensor] = []
        metrics: List[torch.Tensor] = []
        t0 = last_log = time.monotonic()
        while step < max_steps:
            loss, metric = self._train_step(batch)
            step = self.step
            losses.append(loss)
            metrics.append(metric)
            if step % self.log_steps == 0:
                window = torch.stack(losses[-self.log_steps:]).cpu().numpy()
                mwin = torch.stack(metrics[-self.log_steps:]).cpu().numpy()
                now = time.monotonic()
                rate = self.log_steps / max(now - last_log, 1e-9)
                last_log = now
                print(f"step {step}: loss={np.nanmean(window):.4f} "
                      f"metric={np.nanmean(mwin):.4f} ({rate:.1f} steps/s)",
                      flush=True)
            if self.ckpt_steps and step % self.ckpt_steps == 0:
                self.save_checkpoint(step)
            if step < max_steps:
                try:
                    batch = _to_device(next(it), self.device)
                except StopIteration:
                    break
        if self.ckpt_steps:
            self.save_checkpoint(step)
        host_losses = (torch.stack(losses).cpu().numpy() if losses
                       else np.zeros(0, np.float32))
        host_metrics = (torch.stack(metrics).cpu().numpy() if metrics
                        else np.zeros(0, np.float32))
        rate = (step - start_step) / max(time.monotonic() - t0, 1e-9)
        return {
            "loss": _last_finite(host_losses),
            "metric": float(np.nanmean(host_metrics)) if metrics else 0.0,
            "steps_per_sec": rate,
            "global_step": step,
            "skipped_steps": int(self.skipped_steps),
            "losses": host_losses.tolist(),
        }

    def evaluate(self, input_fn, steps: int = 100) -> Dict[str, float]:
        """Mean loss and metric over up to `steps` batches, each batch
        weighted by the sum of its metric_mask (1 without one), as the
        reference weights them."""
        it = input_fn() if callable(input_fn) else input_fn
        self._maybe_restore()
        rows = []
        with eval_mode(self.model), torch.inference_mode():
            for _ in range(steps):
                try:
                    batch = _to_device(next(it), self.device)
                except StopIteration:
                    break
                out = self.model({**batch, **self.static_batch})
                mask = batch.get("metric_mask")
                w = (torch.ones((), device=self.device) if mask is None
                     else mask.to(torch.float32).sum())
                rows.append(torch.stack([out.loss.float(),
                                         out.metric.float(), w]))
        if not rows:
            return {"loss": float("nan"), "metric": float("nan")}
        losses, metrics, w = torch.stack(rows).cpu().double().numpy().T
        w = w / w.sum()
        return {"loss": float(np.dot(losses, w)),
                "metric": float(np.dot(metrics, w))}

    def train_and_evaluate(self, train_input_fn, eval_input_fn,
                           max_steps: int = 1000, eval_steps: int = 50,
                           eval_every: int = 0,
                           keep_best: bool = False) -> Dict[str, Any]:
        """Train, evaluating every `eval_every` steps (0: once at the
        end). keep_best snapshots the parameters at the best interleaved
        eval metric and restores them before the final evaluation."""
        if eval_every <= 0:
            train_res = self.train(train_input_fn, max_steps)
            eval_res = self.evaluate(eval_input_fn, eval_steps)
            return {**{f"train_{k}": v for k, v in train_res.items()},
                    **{f"eval_{k}": v for k, v in eval_res.items()}}
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
                m = self.evaluate(eval_input_fn, eval_steps)["metric"]
                if keep_best and (best_snap is None or m > best_metric):
                    best_metric, best_step = m, step
                    best_snap = {k: v.detach().clone() for k, v in
                                 self.model.state_dict().items()}
                if step < target:
                    break  # train iterator exhausted mid-segment
        finally:
            self.ckpt_steps = saved_ckpt_steps
        if keep_best and best_snap is not None:
            self.model.load_state_dict(best_snap)
        if self.ckpt_steps:
            self.save_checkpoint(step)  # disk matches the reported weights
        eval_res = self.evaluate(eval_input_fn, eval_steps)
        out = {**{f"train_{k}": v for k, v in train_res.items()},
               **{f"eval_{k}": v for k, v in eval_res.items()}}
        if keep_best:
            out["best_step"] = best_step
        return out

    # -- not ported --------------------------------------------------------
    @property
    def input_health(self) -> Dict[str, Any]:
        raise NotImplementedError(
            f"the input-path counters are not ported yet: {_ROADMAP_INPUT}")

    def health(self) -> Dict[str, Any]:
        raise NotImplementedError(
            f"the obs health view is not ported yet: {_ROADMAP_INPUT}")
