"""Dense-batch conversion (counterpart of euler_tpu/utils/to_dense.py:
19-68): node rows and edge lists of packed graphs as fixed-shape
[num_graphs, max_nodes, ...] tensors.

A node's position inside its graph is its rank among the nodes of the
same graph in index order (a stable argsort of graph_idx, then each
graph's first sorted position by searchsorted). Entries past max_nodes,
and edges between graphs, go to one sink row past the dense table,
which is cut off: the shapes depend on num_graphs and max_nodes alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _positions(graph_idx: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """Each node's rank among the nodes of its graph, in index order."""
    n = graph_idx.shape[0]
    gi = graph_idx.long()
    order = torch.argsort(gi, stable=True)
    sorted_gi = gi[order]
    start = torch.searchsorted(
        sorted_gi, torch.arange(num_graphs, device=gi.device))
    pos_sorted = torch.arange(n, device=gi.device) - start[sorted_gi]
    return torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)


def to_dense_batch(x: torch.Tensor, graph_idx: torch.Tensor,
                   num_graphs: int, max_nodes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node rows x [N, D] as [num_graphs, max_nodes, D] and a bool
    mask [num_graphs, max_nodes] of the filled slots; a graph's nodes
    past max_nodes are dropped."""
    pos = _positions(graph_idx, num_graphs)
    keep = pos < max_nodes
    sink = num_graphs * max_nodes
    flat = torch.where(keep, graph_idx.long() * max_nodes + pos,
                       torch.full_like(pos, sink))
    out = x.new_zeros((sink + 1, x.shape[-1]))
    out = out.index_put((flat,), x)
    dense = out[:-1].reshape(num_graphs, max_nodes, x.shape[-1])
    mask = torch.zeros(sink + 1, dtype=torch.bool, device=x.device)
    mask = mask.index_put((flat,), keep)
    return dense, mask[:-1].reshape(num_graphs, max_nodes)


def to_dense_adj(edge_index: torch.Tensor, graph_idx: torch.Tensor,
                 num_graphs: int, max_nodes: int,
                 edge_weight: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """An edge list [2, E] (rows of the node table) as a float32
    adjacency [num_graphs, max_nodes, max_nodes], repeated edges summed
    (weights edge_weight, else 1); an edge with an endpoint past
    max_nodes, or between two graphs, is dropped."""
    pos = _positions(graph_idx, num_graphs)
    gi = graph_idx.long()
    src, dst = edge_index[0].long(), edge_index[1].long()
    g = gi[src]
    ps, pd = pos[src], pos[dst]
    keep = (ps < max_nodes) & (pd < max_nodes) & (gi[dst] == g)
    w = (torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
         if edge_weight is None else edge_weight.to(torch.float32))
    sink = num_graphs * max_nodes * max_nodes
    flat = torch.where(keep, (g * max_nodes + ps) * max_nodes + pd,
                       torch.full_like(src, sink))
    adj = torch.zeros(sink + 1, dtype=torch.float32, device=src.device)
    adj = adj.index_put((flat,), torch.where(keep, w, torch.zeros_like(w)),
                        accumulate=True)
    return adj[:-1].reshape(num_graphs, max_nodes, max_nodes)
