"""Root sampling ops over the global graph (copy of
euler_tpu/ops/sample_ops.py).

Parity: tf_euler/python/euler_ops/sample_ops.py:38 (sample_node),
sample_edge, sample_node_with_types, sample_graph_label analog.
Returns numpy uint64 arrays, ready for a torch.from_numpy copy.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.ops.base import get_graph, get_query


def sample_node(count: int, node_type: int = -1,
                condition: str = "") -> np.ndarray:
    """condition (index DNF, e.g. "price gt 3") restricts sampling to
    matching nodes — the reference's sample_node(condition) via
    `sampleN(...).has(...)` (sample_node_op.cc:61)."""
    if not condition:
        return get_graph().sample_node(count, node_type)
    out = get_query().run(
        f"sampleN({int(node_type)}, {int(count)}).has({condition}).as(n)")
    return out["n:0"].astype(np.uint64).ravel()


def sample_edge(count: int, edge_type: int = -1):
    return get_graph().sample_edge(count, edge_type)


def sample_node_with_types(types) -> np.ndarray:
    return get_graph().sample_node_with_types(types)


def sample_node_with_src(src_nodes, count: int) -> np.ndarray:
    """For each src node, sample `count` nodes of the SAME type —
    type-matched negatives (reference sample_ops.py:75
    sample_node_with_src = get_node_type + sample_n_with_types).
    Returns [len(src), count] uint64."""
    g = get_graph()
    src = np.ascontiguousarray(src_nodes, dtype=np.uint64).ravel()
    types = np.repeat(g.get_node_type(src), count)
    return g.sample_node_with_types(types).reshape(src.size, count)
