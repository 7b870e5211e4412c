"""Host-side batch builders over the graph engine (counterpart of
euler_tpu/dataflow: the fanout, whole, full-batch and layerwise flows;
the relation flow waits for the relational slice)."""

from euler_tpu_torch.dataflow.base_dataflow import (  # noqa: F401
    DataFlow, FanoutDataFlow, FastGCNDataFlow, FullBatchDataFlow,
    LayerwiseDataFlow, WholeDataFlow,
)
