"""The graph engine of the port (counterpart of euler_tpu/graph): the
local engine (api.py), the remote client over a shard cluster
(remote.py), the pipelined client and the client cache (pipeline.py),
fault injection (chaos.py) and ownership maps (elastic.py)."""

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
from euler_tpu_torch.graph.chaos import (  # noqa: F401
    ChaosGraphEngine,
    ChaosPlan,
)
from euler_tpu_torch.graph.pipeline import (  # noqa: F401
    CachedGraphEngine,
    PipelinedClient,
)
from euler_tpu_torch.graph.remote import (  # noqa: F401
    RemoteGraphEngine,
    RetryDeadlineExceeded,
    RetryPolicy,
    configure_rpc,
    retryable_error,
    rpc_transport_stats,
)
