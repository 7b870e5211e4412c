"""An ogbn-products-shaped graph drawn from a seed, on the device.

Frozen copy of the distribution that
euler_tpu_torch/dataset/synthetic.py draws with numpy on the host:
`products_like` (:150) calls `synthetic_citation` (:95) with a quarter of
the degree between communities and three quarters inside them, signal
1.0, and the planetoid split (`planetoid_split`, :78) with
max(20, N / (10 C)) training nodes a class; `to_csr` (:61) stores every
edge both ways, drops repeated (src, dst) pairs and sorts each row. Here
the same draws are made with torch on the device from one generator, so
a graph of 2.45M nodes and 124M directed edges takes seconds, not the
host's 16-26 s. The bits differ from numpy's; the distribution does not.

The number of undirected draws is given whole (`undirected_edges`), so
the graph holds ogbn-products' published 61,859,140 edges both ways,
less the few repeats.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Graph:
    """Node i is row i. offsets [N+1] int64 and neighbors [E] int32 are
    the CSR adjacency; features [N, D] float32; labels [N] int64;
    train_rows the planetoid training split, ascending."""

    offsets: torch.Tensor
    neighbors: torch.Tensor
    features: torch.Tensor
    labels: torch.Tensor
    train_rows: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return int(self.offsets.numel()) - 1


def to_csr(n: int, src: torch.Tensor, dst: torch.Tensor):
    """Undirected pairs → CSR (offsets [n+1] int64, neighbors int32):
    both directions, repeats dropped, each row ascending (to_csr's
    rules)."""
    key = torch.cat([src * n + dst, dst * n + src])
    key = torch.sort(key).values
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    del keep
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    offsets[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
    return offsets, (key % n).to(torch.int32)


def generate(spec: dict, seed: int, device) -> Graph:
    """The graph of a configuration's `graph` entry: num_nodes,
    undirected_edges, intra_share, feat_dim, num_classes, signal."""
    n, d, c = int(spec["num_nodes"]), int(spec["feat_dim"]), \
        int(spec["num_classes"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    labels = torch.randint(0, c, (n,), generator=g, device=device)
    centers = torch.randn(c, d, generator=g, device=device)
    features = float(spec["signal"]) * centers[labels]
    features += torch.randn(n, d, generator=g, device=device)
    # nodes grouped by community, in id order inside each (a stable sort)
    by_class = torch.argsort(labels, stable=True)
    sizes = torch.bincount(labels, minlength=c)
    starts = torch.cumsum(sizes, 0) - sizes
    m = int(spec["undirected_edges"])
    m_intra = int(round(m * float(spec["intra_share"])))
    src = torch.randint(0, n, (m_intra,), generator=g, device=device)
    cls = labels[src]
    within = (torch.rand(m_intra, generator=g, device=device,
                         dtype=torch.float64) * sizes[cls]).long()
    within = torch.minimum(within, sizes[cls] - 1)
    dst = by_class[starts[cls] + within]
    del cls, within
    src2 = torch.randint(0, n, (m - m_intra,), generator=g, device=device)
    dst2 = torch.randint(0, n, (m - m_intra,), generator=g, device=device)
    offsets, neighbors = to_csr(n, torch.cat([src, src2]),
                                torch.cat([dst, dst2]))
    del src, dst, src2, dst2
    per_class = max(20, n // (c * 10))
    rank = torch.arange(n, device=device) - starts[labels[by_class]]
    train_rows = torch.sort(by_class[rank < per_class]).values
    return Graph(offsets, neighbors, features, labels, train_rows)
