"""euler_tpu_torch — the PyTorch/CUDA port of euler_tpu for NVIDIA Hopper.

This package sits beside `euler_tpu` (the JAX reference) and imports
nothing of it: plain tensor code is PyTorch, and the one Pallas kernel
of the reference (`euler_tpu/ops/pallas_ops.py`) is a hand-written
CUDA C++ kernel under `csrc/`, built with nvcc for sm_90a at first use.

The first slice is the GraphSAGE inference-and-serve path:
device-resident neighbor/feature tables → on-device fanout sampling →
`DeviceSampledGraphSage` forward (deepest-hop neighbor mean through the
`gather_mean` kernel) → the embedding sweep of `estimator.infer` →
`serving.engine.EmbeddingEngine`.

Entry points take `device=None`, meaning CUDA; they raise when CUDA is
absent. Pass `device="cpu"` to run the plain PyTorch versions on the
CPU (the tests do).
"""

import os

# torch runs its CPU ops on an OpenMP team whose idle workers busy-wait
# by default. When the scheduler puts the calling thread on the CPU of a
# spinning worker, each parallel op waits out a scheduler slice: the CPU
# paths then run 10-30 times slower, at random. PASSIVE puts idle
# workers to sleep. libgomp reads it once, when torch loads it, so it
# holds where this package is imported before torch; a value the caller
# set stays.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

from euler_tpu_torch.platform import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
