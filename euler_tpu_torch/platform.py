"""Device resolution for the port (counterpart of euler_tpu/platform.py).

The JAX package probes an accelerator backend and may fall back to the
CPU. The port never falls back silently: `device=None` means CUDA, and
asking for CUDA on a machine without it raises. The CPU is used only
when the caller names it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
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


def seeded_generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from a hash of `words` (numpy's
    SeedSequence), as the reference folds words into a JAX key. Packing
    words into bits (a << 32 | b) would not do: torch's CPU generator
    keeps only a seed's low 32 bits, so `a` would be lost there and two
    streams could start from the same state. Every bit of the hash
    depends on every word, on either device."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) >> 1)
    return g


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on `device`. To a card it goes through
    pinned memory with a non-blocking copy: a copy from pageable memory
    waits for the stream's queued work, which would stall a loop that
    feeds the card a batch per step."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
