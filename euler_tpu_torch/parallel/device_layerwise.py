"""Layerwise (LADIES/FastGCN) sampling on the device (counterpart of
euler_tpu/parallel/device_layerwise.py:56-124).

Per layer, over the neighbor tables (DeviceNeighborTable's split
layout, optionally with its alias table):
  - the pool's candidates are the frontier's neighbor slots (the
    previous layer's pool; the roots at layer 0) with their edge
    weights (slot_weights of the cum rows), as the engine's layerwise
    sampler expands each layer from the nodes drawn in the one before;
  - the pool is m_l draws with replacement ∝ slot weight: an inverse
    CDF over the frontier's flat slot weights, `searchsorted(right)`
    clamped to the last slot (a dead frontier, total 0, lands there);
    with the alias table a two-stage draw: a frontier row ∝ its total
    weight, then the alias pick in that row, dead rows to the pad row;
  - the next level is concat(current level, pool), so every level holds
    the one before and a self-loop always finds its column;
  - the dense adjacency [n_l, n_{l+1}] of Â = A + I between the levels
    is built by comparing the current level's neighbor slots against
    the next level's rows (a duplicate pool column receives the weight
    once per copy), plus the self-loops, row-normalized.

Shapes are static: n_0 = B, n_{l+1} = n_l + m_l. The adjacency build
materializes an [n_l, C, n_{l+1}] comparison and its weighted copy, as
the reference's does before XLA fuses them: at bench.py --layerwise's
shape (B 512, pools 512, cap 32) 50.3M elements at layer 1.

Every draw is uniforms → pick. A layer's uniforms are [m] on the split
path and [3, m] with the alias table (row 0 the frontier-row draw, rows
1-2 the alias pick's two uniforms); `uniforms=` replays them (one
tensor per layer), else they come from `generator`. Given the same
uniforms the pools are bit-exact with the reference's where its
cumulative sums and the port's round alike (weights whose float32 sums
are exact in any order always do).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from euler_tpu_torch.parallel.device_sampler import (
    _alias_pick, draw_uniforms, slot_weights,
)


def _inverse_cdf(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """searchsorted(cum, u · cum[-1], right) clamped to the last slot."""
    idx = torch.searchsorted(cum, u * cum[-1], right=True)
    return idx.clamp_max(cum.shape[0] - 1)


def _pool_alias(nbr_f: torch.Tensor, w_f: torch.Tensor,
                cur_f: torch.Tensor, alias_table: torch.Tensor,
                u: torch.Tensor, pad: int) -> torch.Tensor:
    """The two-stage draw: frontier rows ∝ their totals (u[0]), then the
    alias pick inside each chosen row (u[1], u[2]); a dead row's draw is
    the pad row."""
    idx = _inverse_cdf(torch.cumsum(w_f.sum(-1), 0), u[0])
    arow = alias_table[cur_f[idx].long()]                  # [m, C]
    col, deg = _alias_pick(arow, u[1][:, None], u[2][:, None])
    pool = torch.gather(nbr_f[idx], 1, col)[:, 0]          # [m]
    return torch.where(deg > 0, pool, torch.full_like(pool, pad))


def dense_adjacency(nbr: torch.Tensor, w: torch.Tensor, cur: torch.Tensor,
                    nxt: torch.Tensor) -> torch.Tensor:
    """The row-normalized dense [n, n'] adjacency of Â = A + I from the
    current level's neighbor slots nbr [n, C] and their weights w
    [n, C] to the next level's rows nxt [n']: the weights of the slots
    whose neighbor is each column (a duplicate column receives them once
    per copy), plus 1 where the row's own node is the column."""
    hit = nbr[:, :, None] == nxt[None, None, :]             # [n, C, n']
    adj = (w[:, :, None] * hit).sum(dim=1)
    adj = adj + (cur[:, None] == nxt[None, :]).to(adj.dtype)
    return adj / adj.sum(dim=1, keepdim=True).clamp_min(1e-12)


def sample_layerwise_rows(nbr_table: torch.Tensor, cum_table: torch.Tensor,
                          roots: torch.Tensor, layer_sizes: Sequence[int],
                          generator: Optional[torch.Generator] = None,
                          uniforms: Optional[Sequence[torch.Tensor]] = None,
                          alias_table: Optional[torch.Tensor] = None,
                          gather: Optional[Callable] = None
                          ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """roots [B] int32 → (levels, adjs): levels[l] int32 rows (level 0
    the roots, level l+1 level l ++ the pool of layer_sizes[l]); adjs[l]
    the row-normalized dense float32 [n_l, n_{l+1}] adjacency of
    Â = A + I, the batch geometry LayerwiseDataFlow builds on the host
    and LayerEncoder reads. uniforms: one tensor per layer ([m_l], or
    [3, m_l] with alias_table), a replay; else drawn from `generator`
    layer by layer. The pool draws are not over batch rows: inside
    collectives.data_parallel every rank draws the same pools (the
    caller passes the global roots). gather (make_table_gather) reads
    row-sharded split tables; the alias draw takes replicated ones."""
    if uniforms is not None and len(uniforms) != len(layer_sizes):
        raise ValueError(f"need one uniforms tensor per layer "
                         f"({len(layer_sizes)}), got {len(uniforms)}")
    pad = nbr_table.shape[0] - 1
    levels, adjs = [roots], []
    cur = roots
    n_frontier = roots.shape[0]
    for layer, m in enumerate(layer_sizes):
        m = int(m)
        shape = (m,) if alias_table is None else (3, m)
        u = draw_uniforms(shape, generator,
                          None if uniforms is None else uniforms[layer],
                          roots.device, batch_dim=None)
        if gather is None:
            rows = cur.long()
            nbr = nbr_table[rows]                          # [n, C]
            w = slot_weights(cum_table[rows])              # [n, C]
        else:
            nbr = gather(nbr_table, cur)
            w = slot_weights(gather(cum_table, cur))
        # the pool expands the frontier (the last n_frontier rows of
        # cur); the adjacency below needs every row of cur
        nbr_f, w_f = nbr[-n_frontier:], w[-n_frontier:]
        if alias_table is None:
            idx = _inverse_cdf(torch.cumsum(w_f.reshape(-1), 0), u)
            pool = nbr_f.reshape(-1)[idx]
        else:
            pool = _pool_alias(nbr_f, w_f, cur[-n_frontier:], alias_table,
                               u, pad)
        nxt = torch.cat([cur, pool.to(cur.dtype)])          # [n + m]
        n_frontier = m
        adjs.append(dense_adjacency(nbr, w, cur, nxt))
        levels.append(nxt)
        cur = nxt
    return levels, adjs
