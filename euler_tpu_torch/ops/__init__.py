"""Ops of the port: the kernel wrapper modules gather_mean and
row_sparse_adam (each beside its plain PyTorch version; imported as
modules, never shadowed here), the
message-passing primitives (mp_ops), and the op layer over the
process-global graph, which exports what euler_tpu/ops/__init__.py
exports (base, sample_ops, neighbor_ops, feature_ops, type_ops,
walk_ops; host numpy, no torch)."""

from euler_tpu_torch.ops import mp_ops  # noqa: F401
from euler_tpu_torch.ops.base import (  # noqa: F401
    get_graph,
    initialize_embedded_graph,
    initialize_graph,
    initialize_shared_graph,
)
from euler_tpu_torch.ops.feature_ops import (  # noqa: F401
    get_binary_feature,
    get_dense_feature,
    get_edge_binary_feature,
    get_edge_dense_feature,
    get_edge_sparse_feature,
    get_node_type,
    get_sparse_feature,
)
from euler_tpu_torch.ops.neighbor_ops import (  # noqa: F401
    get_full_neighbor,
    get_multi_hop_neighbor,
    get_neighbor_edges,
    get_sorted_full_neighbor,
    get_top_k_neighbor,
    sample_fanout,
    sample_fanout_layerwise,
    sample_fanout_layerwise_each_node,
    sample_fanout_with_feature,
    sample_neighbor,
    sample_neighbor_layerwise,
    sparse_get_adj,
)
from euler_tpu_torch.ops.sample_ops import (  # noqa: F401
    sample_edge,
    sample_node,
    sample_node_with_src,
    sample_node_with_types,
)
from euler_tpu_torch.ops.type_ops import (  # noqa: F401
    ALL_NODE_TYPE,
    get_edge_type_id,
    get_node_type_id,
)
from euler_tpu_torch.ops.walk_ops import gen_pair, random_walk  # noqa: F401
