"""Conv-stack GNNs over edge_index batches (counterpart of
euler_tpu/mp_utils/base_gnn.py:21-137): `get_conv`, `BaseGNNNet` and
`JKGNNNet`.

The batch is a whole node table and its edges (FullBatchDataFlow,
WholeDataFlow): x [N, D], edge_index [2, E], and root_index, the rows
whose embeddings the model returns. Each conv gets the module name flax
gives it (its class name and a count per class: GCNConv_0, GCNConv_1,
or GCNConv_0 then AGNNConv_0 for agnn), so the parameter trees map by
name (euler_tpu_torch.convert). Input dropout before each conv draws
from the batch's dropout_generator in training mode, as the reference's
draws from its "dropout" rng.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch import convolution as C
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense, Dropout

_WAITS = "not ported yet: ROADMAP.md Queue A, 'GNN library breadth'"

_CONV_BUILDERS = {
    "gcn": lambda d_in, dim, i, n, kw, g: C.GCNConv(d_in, dim, generator=g),
    "sage": lambda d_in, dim, i, n, kw, g: C.SAGEConv(d_in, dim,
                                                      generator=g),
    "gat": lambda d_in, dim, i, n, kw, g: C.GATConv(
        d_in, dim, heads=kw.get("heads", 1), generator=g),
    "agnn": lambda d_in, dim, i, n, kw, g: (
        C.GCNConv(d_in, dim, generator=g) if i == 0 else C.AGNNConv(d_in)),
    "gin": lambda d_in, dim, i, n, kw, g: C.GINConv(d_in, dim, generator=g),
    "graph": lambda d_in, dim, i, n, kw, g: C.GraphConv(d_in, dim,
                                                        generator=g),
    "sgcn": lambda d_in, dim, i, n, kw, g: C.SGCNConv(
        d_in, dim, k_hop=kw.get("k_hop", 2), generator=g),
    "tag": lambda d_in, dim, i, n, kw, g: C.TAGConv(
        d_in, dim, k_hop=kw.get("k_hop", 3), generator=g),
    "arma": lambda d_in, dim, i, n, kw, g: C.ARMAConv(
        d_in, dim, num_stacks=kw.get("num_stacks", 2),
        num_layers=kw.get("arma_layers", 1), generator=g),
    "appnp": lambda d_in, dim, i, n, kw, g: C.APPNPConv(
        k_hop=kw.get("k_hop", 10), alpha=kw.get("alpha", 0.1)),
}
# the reference's other two names: GatedGraphConv waits for the
# graph-classification slice, RelationConv for the relational one
_UNPORTED = ("gated", "relation")


def get_conv(name: str, in_dim: int, dim: int, layer_idx: int,
             num_layers: int, kwargs: Dict,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """The conv `name` for layer layer_idx of num_layers, reading its
    options from kwargs (heads, k_hop, num_stacks, arma_layers,
    alpha)."""
    key = name.lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"conv {name!r} is {_WAITS}")
    try:
        build = _CONV_BUILDERS[key]
    except KeyError:
        raise ValueError(
            f"unknown conv {name!r}; options "
            f"{sorted([*_CONV_BUILDERS, *_UNPORTED])}") from None
    return build(in_dim, dim, layer_idx, num_layers, kwargs, generator)


def _width(conv: nn.Module, in_dim: int) -> int:
    """A conv's output width (APPNP's propagation keeps its input's)."""
    return getattr(conv, "out_dim", in_dim)


def _named(counts: Dict[str, int], conv: nn.Module) -> str:
    """flax's automatic name: the class name and its count so far."""
    cls = type(conv).__name__
    counts[cls] = counts.get(cls, -1) + 1
    return f"{cls}_{counts[cls]}"


def _roots(h: torch.Tensor, batch: Dict[str, Any]) -> torch.Tensor:
    """The root rows (repeated roots repeat), through mp_ops.gather, whose
    gradient sums the same bits every run."""
    root = batch.get("root_index")
    return h if root is None else mp.gather(h, root)


class BaseGNNNet(nn.Module):
    """conv_name x num_layers over (x, edge_index), relu between layers;
    returns the root rows' embeddings [B, out_dim].

    appnp predicts, then propagates: mlp_0 (relu), mlp_1, then one
    APPNPConv. sgcn is one SGCNConv of k_hop (default num_layers) steps.
    dropout: the input dropout before each conv (and before appnp's
    mlp), active in training mode only. out_dim: the last layer's width
    (0: dim); self.out_dim is the embedding's width (heads x dim for
    gat's concatenated heads)."""

    def __init__(self, conv_name: str, in_dim: int, dim: int = 32,
                 num_layers: int = 2, out_dim: int = 0,
                 conv_kwargs: Optional[Dict] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_name = conv_name.lower()
        self.num_layers = int(num_layers)
        self.drop = Dropout(dropout)
        kw = conv_kwargs or {}
        last = out_dim or dim
        counts: Dict[str, int] = {}
        self._convs = []
        if self.conv_name == "appnp":
            self.mlp_0 = Dense(in_dim, dim, generator=generator)
            self.mlp_1 = Dense(dim, last, generator=generator)
            convs = [C.APPNPConv(k_hop=kw.get("k_hop", 10),
                                 alpha=kw.get("alpha", 0.1))]
            width = last
        elif self.conv_name == "sgcn":
            convs = [C.SGCNConv(in_dim, last,
                                k_hop=kw.get("k_hop", self.num_layers),
                                generator=generator)]
            width = last
        else:
            convs, width = [], in_dim
            for i in range(self.num_layers):
                d = last if i == self.num_layers - 1 else dim
                convs.append(get_conv(self.conv_name, width, d, i,
                                      self.num_layers, kw, generator))
                width = _width(convs[-1], width)
        for conv in convs:
            name = _named(counts, conv)
            self.add_module(name, conv)
            self._convs.append(name)
        self.out_dim = width

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        x, edge_index = batch["x"], batch["edge_index"]
        gen = batch.get("dropout_generator")
        n = x.shape[0]
        convs = [getattr(self, name) for name in self._convs]
        if self.conv_name == "appnp":
            h = torch.relu(self.mlp_0(self.drop(x, gen)))
            h = convs[0](self.mlp_1(h), edge_index, n)
        elif self.conv_name == "sgcn":
            h = convs[0](x, edge_index, n)
        else:
            h = x
            for i, conv in enumerate(convs):
                h = conv(self.drop(h, gen), edge_index, n)
                if i < self.num_layers - 1:
                    h = torch.relu(h)
        return _roots(h, batch)


class JKGNNNet(nn.Module):
    """Jumping knowledge: the concatenation of every layer's output
    (relu between layers) feeds the head; returns the root rows'
    [B, sum of the layers' widths]."""

    def __init__(self, conv_name: str, in_dim: int, dim: int = 32,
                 num_layers: int = 2, conv_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = int(num_layers)
        counts: Dict[str, int] = {}
        self._convs = []
        width, self.out_dim = in_dim, 0
        for i in range(self.num_layers):
            conv = get_conv(conv_name, width, dim, i, self.num_layers,
                            conv_kwargs or {}, generator)
            width = _width(conv, width)
            self.out_dim += width
            name = _named(counts, conv)
            self.add_module(name, conv)
            self._convs.append(name)

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        x, edge_index = batch["x"], batch["edge_index"]
        n = x.shape[0]
        h, outs = x, []
        for i, name in enumerate(self._convs):
            h = getattr(self, name)(h, edge_index, n)
            if i < self.num_layers - 1:
                h = torch.relu(h)
            outs.append(h)
        return _roots(torch.cat(outs, dim=-1), batch)
