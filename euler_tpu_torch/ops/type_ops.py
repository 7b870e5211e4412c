"""Type-name ops over the global graph (copy of
euler_tpu/ops/type_ops.py).

Parity: tf_euler/python/euler_ops/type_ops.py (get_node_type_id /
get_edge_type_id — data prep declares type NAMES; training code refers
to them by name and these translate to the engine's integer ids).
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.ops.base import get_graph

ALL_NODE_TYPE = -1


def _ids(type_id_or_names, edge: bool):
    g = get_graph()
    if isinstance(type_id_or_names, (list, tuple, np.ndarray)):
        return np.array([g.type_id(t, edge=edge) for t in type_id_or_names],
                        dtype=np.int32)
    return g.type_id(type_id_or_names, edge=edge)


def get_node_type_id(type_id_or_names):
    """Node type name(s) (or int id passthrough) → int id(s)."""
    return _ids(type_id_or_names, edge=False)


def get_edge_type_id(type_id_or_names):
    """Edge type name(s) (or int id passthrough) → int id(s)."""
    return _ids(type_id_or_names, edge=True)
