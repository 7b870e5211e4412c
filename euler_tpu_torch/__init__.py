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

from euler_tpu_torch.platform import resolve_device

__all__ = ["resolve_device"]
