"""euler_tpu_torch.serving: the train→serve seam of the port — export
bundles, an online embedding/kNN inference server over a table on the
device, and a failover-capable client (counterpart of euler_tpu/serving,
whose bundle files and wire frames it shares byte for byte).

    est.train(input_fn, max_steps=...)
    est.export_bundle("bundle/")                    # versioned artifact

    srv = InferenceServer("bundle/", registry="dir:/tmp/reg",
                          service="recs", replica=0)   # table on CUDA
    cli = ServingClient(registry="dir:/tmp/reg", service="recs")
    nbr_ids, scores = cli.knn(user_ids, k=10)       # online retrieval

`InferenceServer(..., device="cpu")` serves from the CPU; without it the
server needs a card and raises when there is none.
"""

from euler_tpu_torch.serving.batcher import (  # noqa: F401
    MicroBatcher,
    ShedError,
    bucket_ladder,
    run_bucketed,
    warm_ladder,
)
from euler_tpu_torch.serving.client import (  # noqa: F401
    ServerOverloaded,
    ServingClient,
)
from euler_tpu_torch.serving.export import (  # noqa: F401
    BundleCorruptionError,
    ModelBundle,
    bundle_shard_count,
    embed_all,
    shard_bounds,
)
from euler_tpu_torch.serving.server import InferenceServer  # noqa: F401
from euler_tpu_torch.serving.autoscale import ServingAutoscaler  # noqa: F401

__all__ = [
    "MicroBatcher", "ShedError", "bucket_ladder", "run_bucketed",
    "warm_ladder", "ServingClient", "ServerOverloaded",
    "BundleCorruptionError", "ModelBundle", "embed_all",
    "shard_bounds", "bundle_shard_count", "InferenceServer",
    "ServingAutoscaler",
]
