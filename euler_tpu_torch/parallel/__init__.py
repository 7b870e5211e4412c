"""The port's device tables and its multi-device layer: features,
labels and neighbors on the device (feature_store, device_sampler,
device_walk, device_layerwise); the ('data', 'model') mesh over
torch.distributed (mesh, multihost, collectives), row-sharded placement
(placement), the sharded embedding and its exchanges
(sharded_embedding, ring_exchange), the partitioned feature store
(partitioned_store), per-device memory arithmetic (memory_plan), the
SPMD train step (train) and the multi-device dry run (dryrun)."""
