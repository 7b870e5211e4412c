"""Device resolution for the port (counterpart of euler_tpu/platform.py).

The JAX package probes an accelerator backend and may fall back to the
CPU. The port never falls back silently: `device=None` means CUDA, and
asking for CUDA on a machine without it raises. The CPU is used only
when the caller names it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None → torch.device("cuda"); "cpu" → the CPU; a CUDA device
    only when CUDA is available. Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
