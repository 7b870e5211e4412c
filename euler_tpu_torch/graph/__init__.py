"""The graph engine of the port (counterpart of euler_tpu/graph: the
local engine; the remote, pipelined, chaos and elastic clients are not
ported yet, ROADMAP.md Queue A, 'Engine binding')."""

from euler_tpu_torch.graph.api import (  # noqa: F401
    BINARY,
    DENSE,
    SPARSE,
    EngineError,
    GraphBuilder,
    GraphEngine,
    delta_dirty_ids,
    seed,
)
