"""Contributed ops of the port (counterpart of euler_tpu/contrib)."""

from euler_tpu_torch.contrib.spmm import spmm  # noqa: F401
