"""Feature ops over the global graph (copy of
euler_tpu/ops/feature_ops.py).

Parity: tf_euler/python/euler_ops/feature_ops.py:111 (get_dense_feature and
the sparse/binary + edge variants backed by Get*Feature TF kernels).
"""

from __future__ import annotations

from euler_tpu_torch.ops.base import get_graph


def get_dense_feature(nodes, feature_ids, dims=None):
    return get_graph().get_dense_feature(nodes, feature_ids, dims)


def get_sparse_feature(nodes, feature_id):
    return get_graph().get_sparse_feature(nodes, feature_id)


def get_binary_feature(nodes, feature_id):
    return get_graph().get_binary_feature(nodes, feature_id)


def get_edge_dense_feature(src, dst, types, feature_ids, dims=None):
    return get_graph().get_edge_dense_feature(src, dst, types, feature_ids, dims)


def get_edge_sparse_feature(src, dst, types, feature_id):
    return get_graph().get_edge_sparse_feature(src, dst, types, feature_id)


def get_edge_binary_feature(src, dst, types, feature_id):
    """(offsets, bytes) CSR of per-edge raw byte strings (parity:
    tf_euler GetEdgeBinaryFeature, kernels/get_edge_binary_feature_op.cc)."""
    return get_graph().get_edge_binary_feature(src, dst, types, feature_id)


def get_node_type(nodes):
    return get_graph().get_node_type(nodes)
