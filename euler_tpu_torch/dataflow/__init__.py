"""Host-side batch builders over the graph engine (counterpart of
euler_tpu/dataflow: the fanout flow; the whole, full-batch, layerwise
and relation flows wait for the slices that own their models)."""

from euler_tpu_torch.dataflow.base_dataflow import (  # noqa: F401
    DataFlow, FanoutDataFlow,
)
