"""Graph-level readout pools (counterpart of euler_tpu/graph_pool/)."""

from euler_tpu_torch.graph_pool.base_pool import (  # noqa: F401
    AttentionPool, MaxPool, MeanPool, Set2SetPool, SumPool,
)
