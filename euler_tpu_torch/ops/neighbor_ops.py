"""Neighbor ops over the global graph (copy of
euler_tpu/ops/neighbor_ops.py).

Parity: tf_euler/python/euler_ops/neighbor_ops.py (sample_neighbor,
sample_fanout at :122, get_full_neighbor, get_sorted_full_neighbor,
get_top_k_neighbor) — shapes are fixed/padded rather than SparseTensor.
"""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.gql import edge_types_str as _et_str
from euler_tpu_torch.ops.base import get_graph, get_query


def sample_neighbor(nodes, count: int, edge_types=None,
                    default_node: int = 0, condition: str = ""):
    """condition (index DNF, e.g. "price gt 3") filters the sampled
    neighbors — the reference appends `.has(condition)` to the sampleNB
    gremlin the same way (sample_neighbor_op.cc:40)."""
    if not condition:
        return get_graph().sample_neighbor(
            nodes, count, edge_types=edge_types, default_id=default_node
        )
    roots = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    out = get_query().run(
        f"v(r).sampleNB({_et_str(edge_types)}, {int(count)}, "
        f"{int(default_node)}).has({condition}).as(nb)", {"r": roots})
    idx = out["nb:0"].reshape(-1, 2).astype(np.int64)
    n = roots.size
    ids = np.full((n, count), np.uint64(default_node), np.uint64)
    w = np.zeros((n, count), np.float32)
    t = np.zeros((n, count), np.int32)
    for i in range(min(n, idx.shape[0])):
        b, e = int(idx[i, 0]), int(idx[i, 1])
        m = min(e - b, count)
        ids[i, :m] = out["nb:1"][b:b + m]
        w[i, :m] = out["nb:2"][b:b + m]
        t[i, :m] = out["nb:3"][b:b + m]
    return ids, w, t


def sample_fanout(nodes, counts, edge_types=None, default_node: int = 0):
    """Multi-hop expansion; returns (layers_ids, layers_weights, layers_types)
    where layers_ids[0] is the input nodes and layers_ids[i+1] the hop-i
    samples (matches the reference's convention of including the roots)."""
    g = get_graph()
    roots = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    ids, w, t = g.sample_fanout(
        roots, counts, edge_types=edge_types, default_id=default_node
    )
    return [roots] + ids, w, t


def _conditioned_full_neighbor(nodes, edge_types, condition, verb):
    roots = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    out = get_query().run(
        f"v(r).{verb}({_et_str(edge_types)}).has({condition}).as(nb)",
        {"r": roots})
    idx = out["nb:0"].reshape(-1, 2)
    offsets = np.concatenate([[0], idx[:, 1]]).astype(np.uint64)
    return (offsets, out["nb:1"].astype(np.uint64),
            out["nb:2"].astype(np.float32), out["nb:3"].astype(np.int32))


def get_full_neighbor(nodes, edge_types=None, condition: str = ""):
    if condition:
        return _conditioned_full_neighbor(nodes, edge_types, condition,
                                          "getNB")
    return get_graph().get_full_neighbor(nodes, edge_types=edge_types)


def get_sorted_full_neighbor(nodes, edge_types=None, condition: str = ""):
    if condition:
        return _conditioned_full_neighbor(nodes, edge_types, condition,
                                          "getSortedNB")
    return get_graph().get_full_neighbor(
        nodes, edge_types=edge_types, sorted_by_id=True
    )


def get_neighbor_edges(nodes, edge_types=None):
    """Edges to each node's out-neighbors (reference API_GET_NB_EDGE /
    GQL outE): (offsets, src, dst, types, weights) CSR arrays whose
    triples chain into feature_ops.get_edge_dense_feature."""
    return get_graph().get_neighbor_edges(nodes, edge_types=edge_types)


def get_top_k_neighbor(nodes, k: int, edge_types=None,
                       default_node: int = 0, condition: str = ""):
    """condition filters candidate neighbors before the weight-ordered
    top-k (reference get_top_k_neighbor_op.cc:34: outE.has(cond)
    .order_by(weight, desc).limit(k))."""
    if not condition:
        return get_graph().get_top_k_neighbor(
            nodes, k, edge_types=edge_types, default_id=default_node
        )
    # node-attribute conditions filter the neighbor set (getNB.has,
    # index-backed), then weight-ordered top-k per row
    roots = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    off, nbr, w_all, t_all = _conditioned_full_neighbor(
        roots, edge_types, condition, "getNB")
    n = roots.size
    ids = np.full((n, k), np.uint64(default_node), np.uint64)
    w = np.zeros((n, k), np.float32)
    t = np.zeros((n, k), np.int32)
    for i in range(n):
        b, e = int(off[i]), int(off[i + 1])
        if e <= b:
            continue
        order = np.argsort(-w_all[b:e], kind="stable")[:k]
        m = order.size
        ids[i, :m] = nbr[b:e][order]
        w[i, :m] = w_all[b:e][order]
        t[i, :m] = t_all[b:e][order]
    return ids, w, t


def sample_neighbor_layerwise(nodes, layer_sizes, edge_types=None,
                              default_node: int = 0,
                              weight_func: str = ""):
    """LADIES-style layerwise sampling (reference sampleLNB /
    SampleNeighborLayerwiseWithAdj). weight_func '' or 'sqrt' (the
    reference's hub-dampening transform of the accumulated candidate
    weight, local_sample_layer_op.cc:94)."""
    return get_graph().sample_layerwise(
        nodes, layer_sizes, edge_types=edge_types, default_id=default_node,
        weight_func=weight_func
    )


def get_multi_hop_neighbor(nodes, edge_types_per_hop):
    """Full multi-hop expansion with inter-hop adjacency (reference
    neighbor_ops.py:209 get_multi_hop_neighbor).

    edge_types_per_hop: one edge-type filter per hop (None = all).
    Returns (nodes_list, adj_list): nodes_list[h] is the UNIQUE node ids
    of hop h (h=0 is the roots); adj_list[h] is the
    (edge_index [2, E] int32, weights [E]) sparse adjacency from
    nodes_list[h] rows to nodes_list[h+1] rows (the sparse_get_adj
    convention)."""
    g = get_graph()
    cur = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    nodes_list = [cur]
    adj_list = []
    for ets in edge_types_per_hop:
        off, ids, w, _ = g.get_full_neighbor(cur, edge_types=ets)
        nxt = np.unique(ids) if ids.size else np.zeros(0, np.uint64)
        src_rows = np.repeat(np.arange(cur.size),
                             np.diff(off.astype(np.int64)))
        # nxt is sorted-unique → vectorized position lookup (a dict per
        # hop would put O(E) Python work on the host feeder path)
        dst_rows = np.searchsorted(nxt, ids).astype(np.int32)
        adj_list.append((
            np.stack([src_rows.astype(np.int32), dst_rows]),
            np.asarray(w, np.float32)))
        nodes_list.append(nxt)
        cur = nxt
    return nodes_list, adj_list


def sample_fanout_layerwise_each_node(nodes, layer_counts, edge_types=None,
                                      default_node: int = 0):
    """Hop 1 = per-node sample_neighbor; later hops = one shared
    layerwise pool per hop (reference neighbor_ops.py:161). Returns the
    per-hop node arrays [roots, hop1, pool2, ...]."""
    g = get_graph()
    cur = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    out = [cur]
    for h, m in enumerate(layer_counts):
        if h == 0:
            nb, _, _ = g.sample_neighbor(cur, int(m),
                                         edge_types=edge_types,
                                         default_id=default_node)
            cur = nb.reshape(-1)
        else:
            cur = g.sample_layerwise(cur, [int(m)], edge_types=edge_types,
                                     default_id=default_node)[0]
        out.append(cur)
    return out


def sample_fanout_layerwise(nodes, layer_counts, edge_types=None,
                            default_node: int = 0, weight_func: str = ""):
    """Every hop a shared layerwise pool (reference neighbor_ops.py:189).
    Returns [roots, pool1, pool2, ...]."""
    g = get_graph()
    cur = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    out = [cur]
    for m in layer_counts:
        cur = g.sample_layerwise(cur, [int(m)], edge_types=edge_types,
                                 default_id=default_node,
                                 weight_func=weight_func)[0]
        out.append(cur)
    return out


def sample_fanout_with_feature(nodes, counts, edge_types=None,
                               default_node: int = 0,
                               dense_feature_names=(), dense_dimensions=(),
                               sparse_feature_names=()):
    """Fanout + per-hop feature fetch in one call (reference
    neighbor_ops.py:49 SampleFanoutWithFeature). Returns
    (neighbors, weights, types, dense_features, sparse_features):
    neighbors has len(counts)+1 per-hop id arrays (roots first);
    dense_features is hop-major then feature-major ([hop][feat] →
    [n_hop, dim]); sparse_features likewise with (offsets, values)
    CSR pairs."""
    g = get_graph()
    roots = np.ascontiguousarray(nodes, dtype=np.uint64).ravel()
    ids, w, t = g.sample_fanout(roots, list(counts),
                                edge_types=edge_types,
                                default_id=default_node)
    neighbors = [roots] + list(ids)
    # one native call PER FEATURE over the concatenated hops, split back
    # by hop sizes — not hops x features round trips (host feeder path)
    flat = np.concatenate(neighbors)
    splits = np.cumsum([len(h) for h in neighbors])[:-1]
    dense, sparse = [], []
    if dense_feature_names:
        dims = list(dense_dimensions) if dense_dimensions else None
        per_feat = g.get_dense_feature(flat, list(dense_feature_names),
                                       dims)
        by_hop = [np.split(f, splits) for f in per_feat]   # [feat][hop]
        dense = [[by_hop[f][h] for f in range(len(per_feat))]
                 for h in range(len(neighbors))]           # [hop][feat]
    if sparse_feature_names:
        per_feat_sp = []
        for fname in sparse_feature_names:
            offs, vals = g.get_sparse_feature(flat, fname)
            offs = offs.astype(np.int64)
            hop_feats = []
            lo = 0
            for h in neighbors:
                hi = lo + len(h)
                o = offs[lo:hi + 1] - offs[lo]
                hop_feats.append((o.astype(np.uint64),
                                  vals[offs[lo]:offs[hi]]))
                lo = hi
            per_feat_sp.append(hop_feats)                  # [feat][hop]
        sparse = [[per_feat_sp[f][h]
                   for f in range(len(sparse_feature_names))]
                  for h in range(len(neighbors))]          # [hop][feat]
    return neighbors, w, t, dense, sparse


def sparse_get_adj(roots, nbr_ids, edge_types=None):
    """Adjacency between a root batch and a candidate neighbor set.

    Parity: reference SparseGetAdj (API_SPARSE_GET_ADJ,
    ops/euler_ops.cc:22-37; used by layerwise dataflows to connect each
    layer to the next layer's sampled pool).

    Returns (edge_index [2, E] int32, weights [E]) where edge_index[0]
    indexes `roots` rows and edge_index[1] indexes `nbr_ids` rows; only
    edges whose destination is in nbr_ids survive.
    """
    import numpy as np

    roots = np.ascontiguousarray(roots, dtype=np.uint64).ravel()
    nbr_ids = np.ascontiguousarray(nbr_ids, dtype=np.uint64).ravel()
    pos = {int(v): i for i, v in enumerate(nbr_ids)}
    off, ids, w, _ = get_graph().get_full_neighbor(roots,
                                                   edge_types=edge_types)
    src_rows, dst_rows, ws = [], [], []
    for i in range(len(roots)):
        for j in range(int(off[i]), int(off[i + 1])):
            p = pos.get(int(ids[j]))
            if p is not None:
                src_rows.append(i)
                dst_rows.append(p)
                ws.append(w[j])
    return (np.array([src_rows, dst_rows], dtype=np.int32),
            np.array(ws, dtype=np.float32))
