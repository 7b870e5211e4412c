"""Multi-group (heterogeneous) conv stacks (counterpart of
euler_tpu/mp_utils/group_gnn.py:19-54): one BaseGNNNet per edge group,
the groups' root embeddings combined by attention."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch.mp_utils.base_gnn import BaseGNNNet
from euler_tpu_torch.utils.layers import AttLayer


class GroupGNNNet(nn.Module):
    """A conv stack per group over that group's edges,
    batch["group_edge_index"][g] ([2, E_g]; the host flow filters the
    edges by type): "gnn_{g}" per group, or one "gnn" that every group
    shares when shared. The [B, G, dim] stack of the groups' root rows
    goes through AttLayer ("combine") → [B, dim]."""

    def __init__(self, in_dim: int, conv_name: str = "gcn", dim: int = 32,
                 num_layers: int = 2, num_groups: int = 2,
                 shared: bool = False, conv_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_groups = int(num_groups)
        self.shared = bool(shared)
        for g in ([None] if self.shared else range(self.num_groups)):
            net = BaseGNNNet(conv_name, in_dim, dim, num_layers,
                             conv_kwargs=conv_kwargs, generator=generator)
            self.add_module("gnn" if g is None else f"gnn_{g}", net)
        width = net.out_dim
        self.combine = AttLayer(width, dim, generator=generator)
        self.out_dim = width

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        outs = []
        for g in range(self.num_groups):
            net = getattr(self, "gnn" if self.shared else f"gnn_{g}")
            outs.append(net({**batch,
                             "edge_index": batch["group_edge_index"][g]}))
        return self.combine(torch.stack(outs, dim=1))         # [B, G, D]


class SharedGroupGNNNet(GroupGNNNet):
    """GroupGNNNet with one conv stack ("gnn") shared by every group."""

    def __init__(self, in_dim: int, conv_name: str = "gcn", dim: int = 32,
                 num_layers: int = 2, num_groups: int = 2,
                 conv_kwargs: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, conv_name, dim, num_layers, num_groups,
                         shared=True, conv_kwargs=conv_kwargs,
                         generator=generator)
