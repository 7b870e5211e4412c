"""Host-side batch builders over the graph engine (counterpart of
euler_tpu/dataflow: the fanout, whole, full-batch, layerwise and
relation flows, and Block)."""

from euler_tpu_torch.dataflow.base_dataflow import (  # noqa: F401
    Block, DataFlow, FanoutDataFlow, FastGCNDataFlow, FullBatchDataFlow,
    LayerwiseDataFlow, RelationDataFlow, WholeDataFlow,
)
