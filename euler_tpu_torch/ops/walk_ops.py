"""Random walks and skip-gram pairs over the op layer's graph (copy of
euler_tpu/ops/walk_ops.py): random_walk reads the process-global graph
that ops.base.initialize_graph set, as the reference's does. Nothing
here is torch."""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.ops.base import get_graph


def random_walk(nodes, walk_len: int, p: float = 1.0, q: float = 1.0,
                edge_types=None, default_node: int = 0) -> np.ndarray:
    """[n, walk_len+1] uint64 walks, column 0 = the input nodes (the
    engine's node2vec walk with return parameter p, in-out parameter
    q)."""
    return get_graph().random_walk(nodes, walk_len, p=p, q=q,
                                   edge_types=edge_types,
                                   default_id=default_node)


def gen_pair(paths: np.ndarray, left_win_size: int,
             right_win_size: int) -> np.ndarray:
    """Skip-gram (center, context) pairs from walk paths (copy of the
    reference's gen_pair).

    paths: [n, L]. Returns [n, num_pairs, 2]: for each center column i,
    the context columns i-left_win_size .. i+right_win_size inside the
    path (a window clipped at the path's ends yields fewer pairs, the
    same number for every row, so the shape is static).
    """
    paths = np.asarray(paths)
    n, L = paths.shape
    pairs = []
    for i in range(L):
        for off in range(-left_win_size, right_win_size + 1):
            if off == 0:
                continue
            j = i + off
            if j < 0 or j >= L:
                continue
            pairs.append(np.stack([paths[:, i], paths[:, j]], axis=1))
    if not pairs:
        return np.zeros((n, 0, 2), dtype=paths.dtype)
    return np.stack(pairs, axis=1)
