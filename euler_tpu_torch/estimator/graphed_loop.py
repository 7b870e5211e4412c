"""K training steps as one CUDA graph (counterpart of
euler_tpu/estimator/base_estimator.py:_build_train_loop, :319-333, the
`lax.scan` of K steps that the reference dispatches at once when
params["steps_per_loop"] = K > 1).

Eager PyTorch costs the host several milliseconds of Python and kernel
launches per step. A CUDA graph that holds K whole steps (forward with
the on-device neighbor draws and the gather_mean kernel, backward, the
nonfinite guard, fused Adam) costs one replay per K steps.

What a replay reads is fixed at capture:
- static inputs: every tensor of a batch (the root rows, and replayed
  uniforms or labels where a batch has them) stacked [K, ...]; a replay
  copies the window's batches in with one stack per key, on the stream
  the replay runs on, so a copy never overtakes the replay before it;
- K sampling and K dropout generators, made once and registered with
  the graph. torch reads a registered generator's seed and offset when
  the graph replays, so re-seeding one with the seed a fresh generator
  would get (`sample_stream_seed(sample_seed, word)` with the model's
  `stream_word`; seed_words(seed + 1, step, 0xD0)) makes the replayed
  step draw the bits of the eager step.
  One generator per step: sharing one across the K steps would shift
  which uniforms a step gets;
- the parameters, the optimizer's state, the guard's skip count and the
  static tables (estimator.static_batch), by address.

Static outputs (the K losses and metrics) are overwritten by the next
replay, so `run` returns clones.

The first window, and the first after anything that can move a captured
address, runs eagerly as K real training steps (no step is wasted or
repeated) on the side stream that then captures the graph: that warms
cuBLAS and the allocator on that stream and makes Adam's lazy state.
Recapture follows `invalidate()` (the estimator calls it when
restore_checkpoint replaces the optimizer's state tensors) and any
change of the batches' keys, shapes or dtypes, of the static tables or
of the model's train/eval mode. model.load_state_dict copies in place
and needs none.

The capture runs in capture_error_mode "thread_local": a feeder thread
(estimator/prefetch.py) may be moving the next batches to the card
while the main thread captures, and its pinned-memory allocator queries
CUDA events, which the default "global" mode forbids in every thread
during a capture. The capturing thread is still held to the rules.

A capture that fails raises with its reason; nothing falls back to the
eager loop. On the CPU the estimator runs the K steps eagerly and never
builds this class.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from euler_tpu_torch.models.graphsage import sample_stream_seed
from euler_tpu_torch.ops.gather_mean import gather_mean


def _describe(v: Any):
    """What a captured step depends on in a batch value: dtype and shape
    of a tensor (or of each tensor of a list); None for host values."""
    if isinstance(v, torch.Tensor):
        return (v.dtype, tuple(v.shape), v.device)
    if isinstance(v, (list, tuple)) and v and all(
            isinstance(x, torch.Tensor) for x in v):
        return tuple(_describe(x) for x in v)
    return None


class GraphedLoop:
    """The K-step CUDA graph of one BaseEstimator on a CUDA device. It
    holds no reference to the estimator (each call passes it), so
    dropping the estimator frees the graph and its memory pool without
    waiting for the cycle collector.

    Counts for the record: `captures`, `replays`, and
    `launches_per_replay`, the gather_mean launches recorded into the
    graph by its capture (the wrapper counts host calls, so a replay
    adds nothing to gather_mean.launches)."""

    def __init__(self, device: torch.device, steps: int):
        if device.type != "cuda":
            raise ValueError("the K-step graph runs on a CUDA device")
        self.steps = int(steps)
        self._stream = torch.cuda.Stream(device=device)
        self._sample_gens = [torch.Generator(device=device)
                             for _ in range(self.steps)]
        self._dropout_gens = [torch.Generator(device=device)
                              for _ in range(self.steps)]
        self.captures = 0
        self.replays = 0
        self.launches_per_replay = 0
        self.invalidate()

    def invalidate(self) -> None:
        """Drop the graph (and its memory pool); the next window warms
        up and captures again."""
        self.graph = None
        self._key = None
        self._inputs: Dict[str, Any] = {}
        self._losses = self._metrics = None

    # -- what the graph depends on ------------------------------------------
    def _signature(self, est, batches: Sequence[Dict[str, Any]]):
        layouts = [tuple(sorted((k, _describe(v)) for k, v in b.items()))
                   for b in batches]
        if any(x != layouts[0] for x in layouts[1:]):
            raise ValueError("the batches of a K-step window differ in "
                             "keys, shapes or dtypes")
        tables = tuple(sorted(
            (k, v.data_ptr(), tuple(v.shape), v.dtype)
            if isinstance(v, torch.Tensor) else (k, id(v))
            for k, v in est.static_batch.items()))
        return layouts[0], tables, est.model.training

    def _tensor_keys(self, batch: Dict[str, Any]) -> List[str]:
        return [k for k, v in batch.items() if _describe(v) is not None]

    # -- the window -----------------------------------------------------------
    def run(self, est, batches: Sequence[Dict[str, Any]]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K training steps of `est` on K batches already on the card;
        its step advances by K. Returns (losses [K], metrics [K]) on the
        card."""
        if len(batches) != self.steps:
            raise ValueError(f"a window takes {self.steps} batches, got "
                             f"{len(batches)}")
        key = self._signature(est, batches)
        if self.graph is None or key != self._key:
            self.invalidate()
            out = self._warm_up(est, batches)
            self._capture(est, batches, key)
            return out
        for k in self._tensor_keys(batches[0]):
            static = self._inputs[k]
            if isinstance(static, list):
                for h, dst in enumerate(static):
                    torch.stack([b[k][h] for b in batches], out=dst)
            else:
                torch.stack([b[k] for b in batches], out=static)
        self._seed(est, batches)
        self.graph.replay()
        self.replays += 1
        est.step += self.steps
        return self._losses.clone(), self._metrics.clone()

    def _seed(self, est, batches) -> None:
        step0 = est.step
        for k, b in enumerate(batches):
            if "sample_seed" in b:
                # the model's stream word, as its eager step seeds its
                # stream (host-fed models sample nothing and have none)
                self._sample_gens[k].manual_seed(sample_stream_seed(
                    b["sample_seed"], type(est.model).stream_word))
            if est.uses_dropout:
                self._dropout_gens[k].manual_seed(
                    est.dropout_seed(step0 + k))

    def _warm_up(self, est, batches):
        """The window as K eager steps on the capture stream."""
        main = torch.cuda.current_stream(est.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            outs = [est._train_step(b) for b in batches]
            losses = torch.stack([o[0] for o in outs])
            metrics = torch.stack([o[1] for o in outs])
        main.wait_stream(self._stream)
        return losses, metrics

    def _capture(self, est, batches, key) -> None:
        graph = torch.cuda.CUDAGraph()
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                f"torch {torch.__version__} cannot register generators "
                "with a CUDA graph (CUDAGraph.register_generator_state): "
                "the K-step graph's sampling and dropout draws would be "
                "frozen at capture")
        has_seed = "sample_seed" in batches[0]
        gens = self._sample_gens if has_seed else []
        if est.uses_dropout:
            gens = gens + self._dropout_gens
        for g in gens:
            register(g)
        inputs = {}
        for k in self._tensor_keys(batches[0]):
            v = batches[0][k]
            if isinstance(v, torch.Tensor):
                inputs[k] = torch.stack([b[k] for b in batches])
            else:
                inputs[k] = [torch.stack([b[k][h] for b in batches])
                             for h in range(len(v))]
        launches = gather_mean.launches
        try:
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                losses, metrics = [], []
                for i in range(self.steps):
                    b = {k: (v[i] if isinstance(v, torch.Tensor)
                             else [x[i] for x in v])
                         for k, v in inputs.items()}
                    b.update(est.static_batch)
                    if has_seed:
                        b["sample_generator"] = self._sample_gens[i]
                    if est.uses_dropout:
                        b["dropout_generator"] = self._dropout_gens[i]
                    loss, metric = est._update(b)
                    losses.append(loss)
                    metrics.append(metric)
                out = (torch.stack(losses), torch.stack(metrics))
        except Exception as e:
            self.invalidate()
            raise RuntimeError(
                f"capture of the {self.steps}-step CUDA graph failed "
                f"({type(e).__name__}: {e}); the eager loop is not used "
                "in its place") from e
        self.launches_per_replay = gather_mean.launches - launches
        self.graph, self._key, self._inputs = graph, key, inputs
        self._losses, self._metrics = out
        self.captures += 1
