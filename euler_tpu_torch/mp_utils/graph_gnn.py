"""Graph-level GNNs, classification over whole graphs (counterpart of
euler_tpu/mp_utils/graph_gnn.py:33-91): `GraphGNNNet` and `GraphModel`.

A batch packs num_graphs small graphs into one node table
(GraphEstimator): x [N, D], edge_index [2, E], graph_index [N] (each
node's graph), labels [G] and graph_mask [G] (0 for a shape-padding
graph slot). num_graphs is a constructor argument, as the reference's
is static. The modules keep flax's names (gnn, GINConv_0, ...,
SumPool_0 / AttentionPool_0 / Set2SetPool_0, out), so
euler_tpu_torch.convert maps the parameter trees.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch import graph_pool as P
from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.mp_utils.base_gnn import _named, _width, get_conv
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import Dense, dropout

_POOLS = {
    "sum": lambda d_in, dim, g: P.SumPool(),
    "mean": lambda d_in, dim, g: P.MeanPool(),
    "max": lambda d_in, dim, g: P.MaxPool(),
    "attention": lambda d_in, dim, g: P.AttentionPool(d_in, dim,
                                                      generator=g),
    "set2set": lambda d_in, dim, g: P.Set2SetPool(d_in, dim, generator=g),
}


class GraphGNNNet(nn.Module):
    """conv_name x num_layers over (x, edge_index), relu between layers,
    then the readout pool_name (sum, mean, max, attention, set2set) over
    graph_index: the graph embeddings [num_graphs, out_dim] (out_dim is
    dim, 2·dim for set2set)."""

    def __init__(self, conv_name: str, in_dim: int, pool_name: str = "sum",
                 dim: int = 32, num_layers: int = 2, num_graphs: int = 0,
                 conv_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = int(num_layers)
        self.num_graphs = int(num_graphs)
        kw = conv_kwargs or {}
        counts: Dict[str, int] = {}
        self._convs = []
        width = in_dim
        for i in range(self.num_layers):
            conv = get_conv(conv_name, width, dim, i, self.num_layers, kw,
                            generator)
            width = _width(conv, width)
            name = _named(counts, conv)
            self.add_module(name, conv)
            self._convs.append(name)
        pool = _POOLS[pool_name.lower()](width, dim, generator)
        self._pool = _named(counts, pool)
        self.add_module(self._pool, pool)
        self.out_dim = getattr(pool, "out_dim", width)

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        x, edge_index = batch["x"], batch["edge_index"]
        n = x.shape[0]
        h = x
        for i, name in enumerate(self._convs):
            h = getattr(self, name)(h, edge_index, n)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return getattr(self, self._pool)(h, batch["graph_index"],
                                         self.num_graphs)


class GraphModel(nn.Module):
    """Supervised graph classification: GraphGNNNet ("gnn") → readout
    dropout (training mode only, its mask from the batch's
    dropout_generator) → Dense "out" → softmax cross-entropy against the
    integer labels [G]. With a graph_mask the loss and the accuracy are
    means over the real graphs only; the metric is "acc"."""

    def __init__(self, in_dim: int, conv_name: str = "gin",
                 pool_name: str = "sum", dim: int = 32, num_layers: int = 2,
                 num_graphs: int = 0, num_classes: int = 2,
                 conv_kwargs: Optional[Dict] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.dropout = float(dropout)
        self.gnn = GraphGNNNet(conv_name, in_dim, pool_name, dim, num_layers,
                               num_graphs, conv_kwargs, generator=generator)
        self.out = Dense(self.gnn.out_dim, num_classes, generator=generator)

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        emb = self.gnn(batch)
        if self.dropout > 0.0 and self.training:
            emb = dropout(emb, self.dropout, batch.get("dropout_generator"))
        logits = self.out(emb)
        labels = batch["labels"].long()
        per = F.cross_entropy(logits, labels, reduction="none")
        mask = batch.get("graph_mask")
        if mask is not None:
            m = mask.to(per.dtype)
            denom = m.sum().clamp_min(1.0)
            loss = (per * m).sum() / denom
            acc = ((logits.argmax(-1) == labels) * m).sum() / denom
        else:
            loss = per.mean()
            acc = M.accuracy(logits, labels)
        return ModelOutput(emb, loss, "acc", acc)
