"""Device-resident random walks, skip-gram pairs and global node draws
(counterpart of euler_tpu/parallel/device_walk.py): the input path of
the device-sampled unsupervised family (unsupervised GraphSAGE,
DeepWalk, node2vec, LINE).

A walk is walk_len chained one-neighbor draws over the neighbor table
(parallel/device_sampler.py); pairs are fixed index arithmetic over the
walk's columns; negatives are an inverse-CDF draw over a node-weight
cumsum. As in device_sampler, every draw is uniforms → pick: the
uniforms come from the caller's torch.Generator, or are passed in (a
replay), and given the same uniforms the picks are bit-exact with the
JAX package's.

Dead ends stay at the table's pad row; the models mask pairs that
touch it out of the loss and the metric.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from euler_tpu_torch.parallel.device_sampler import (
    draw_uniforms, sample_hop, slot_weights,
)
from euler_tpu_torch.platform import DeviceLike, resolve_device

# float32 holds every integer up to 2^24 exactly: a cumsum of unit
# weights over more nodes than that no longer tells neighbors apart
_EXACT_UNIT_CUMSUM_ROWS = 1 << 24


class DeviceNodeSampler:
    """Weighted draws of table rows over all nodes (negatives, root
    pools): a row pool and its inclusive float32 cumulative weights on
    one device (counterpart of the reference's DeviceNodeSampler,
    euler_tpu/parallel/device_walk.py:48-67).

    DeviceNodeSampler(graph, node_type) reads the engine as the
    reference does: engine rows (all_node_ids order) and node weights,
    only the rows of node_type when it is >= 0; from_arrays builds the
    same from a weight array.

    With unit weights the float32 cumsum is exact up to 2^24 nodes
    (16.7M; bench.py's graph has 2.45M); past that, neighboring rows
    share a cumsum value and the later one is never drawn, in the
    reference too."""

    def __init__(self, graph, node_type: int = -1,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        ids = graph.all_node_ids()
        types = graph.get_node_type(ids) if node_type >= 0 else None
        self._fill(graph.all_node_weights(), types, node_type, dev)

    @classmethod
    def from_arrays(cls, node_weights: np.ndarray,
                    node_types: Optional[np.ndarray] = None,
                    node_type: int = -1,
                    device: DeviceLike = None) -> "DeviceNodeSampler":
        """node_weights [N] (row i is node i); node_type >= 0 keeps only
        the rows whose node_types entry equals it."""
        dev = resolve_device(device)
        if node_type >= 0 and node_types is None:
            raise ValueError("node_type >= 0 needs node_types")
        self = cls.__new__(cls)
        self._fill(node_weights, node_types, node_type, dev)
        return self

    def _fill(self, node_weights, node_types, node_type: int,
              dev: torch.device) -> None:
        w = np.asarray(node_weights, np.float32).ravel()
        rows = np.arange(len(w), dtype=np.int32)
        if node_type >= 0:
            keep = np.asarray(node_types).ravel() == node_type
            rows, w = rows[keep], w[keep]
        if len(rows) == 0:
            raise ValueError("the node sampler's pool is empty")
        self.device = dev
        self.rows = torch.from_numpy(rows).to(dev)
        self.cum = torch.from_numpy(np.cumsum(w, dtype=np.float32)).to(dev)

    @property
    def tables(self):
        """Tensors to merge into a model's static batch."""
        return {"neg_rows": self.rows, "neg_cum": self.cum}


def sample_global_rows(pool_rows: torch.Tensor, pool_cum: torch.Tensor,
                       shape: Tuple[int, ...],
                       generator: Optional[torch.Generator] = None,
                       uniforms: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Weighted draw of `shape` rows from a (pool, cum) node sampler:
    u·total, the left-side searchsorted (jnp.searchsorted's side), a
    clip to the pool, a take."""
    u = draw_uniforms(shape, generator, uniforms, pool_cum.device)
    idx = torch.searchsorted(pool_cum, u.reshape(-1) * pool_cum[-1])
    idx = idx.clamp(0, pool_rows.shape[0] - 1)
    return pool_rows[idx].reshape(shape)


def walk_rows(nbr_table: torch.Tensor, cum_table: torch.Tensor,
              roots: torch.Tensor, walk_len: int,
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[Sequence[torch.Tensor]] = None,
              p: float = 1.0, q: float = 1.0,
              uniform: bool = False,
              alias_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] roots → [B, walk_len + 1] row walks, column 0 the roots.

    uniforms: optional one tensor per step (a replay): [B], or [2, B]
    for a step that takes the alias draw; else each step draws its
    uniforms from `generator`, in step order.

    The first step, and every step when p == q == 1, is one neighbor
    draw (sample_hop with count 1; uniform=True takes the one-gather
    unit-weight draw, alias_table the alias draw, which wins over
    uniform as in the reference). Otherwise node2vec's second-order bias scales
    each candidate's slot weight by 1/p when it returns to the previous
    node, 1 when it is a kept neighbor of the previous node, 1/q else
    (C x C compares over the capped rows), then draws by inverse CDF
    over the biased row; a row of total weight 0 stays at its pad. That
    path always reads the cum table: it needs raw slot weights, and
    ignores alias_table and uniform, as the reference does.

    Its row cumsum may add in another order than XLA's, so with
    replayed uniforms a pick can differ from the reference's where u
    falls on a boundary that the two orders round differently; weights
    that float32 sums exactly in any order (unit slots with p = 0.5,
    q = 2) give the same picks."""
    if uniforms is not None and len(uniforms) != walk_len:
        raise ValueError(f"need one uniforms tensor per step ({walk_len}), "
                         f"got {len(uniforms)}")
    B = roots.shape[0]
    C = nbr_table.shape[1]
    unif = uniform and alias_table is None

    def step_u(i, shape):
        return draw_uniforms(shape, generator,
                         None if uniforms is None else uniforms[i],
                         roots.device)

    def draw(rows, i):
        shape = (B,) if alias_table is None else (2, B)
        u = step_u(i, shape).reshape(*shape[:-1], B, 1)
        return sample_hop(nbr_table, cum_table, rows, 1, uniforms=u,
                          uniform=unif, alias_table=alias_table)

    cols = [roots]
    cur = draw(roots, 0)
    cols.append(cur)
    prev = roots
    for i in range(1, walk_len):
        if p == 1.0 and q == 1.0:
            nxt = draw(cur, i)
        else:
            u = step_u(i, (B,))
            cand = nbr_table[cur.long()]                      # [B, C]
            w = slot_weights(cum_table[cur.long()])           # [B, C]
            prev_nbr = nbr_table[prev.long()]                 # [B, C]
            is_prev = cand == prev[:, None]
            in_prev_nbr = (cand[:, :, None]
                           == prev_nbr[:, None, :]).any(-1)
            # pad candidates keep weight 0 whatever their bias
            bias = torch.where(is_prev, 1.0 / p,
                               torch.where(in_prev_nbr, 1.0, 1.0 / q))
            bcum = torch.cumsum(w * bias, dim=1)
            total = bcum[:, -1]
            col = (bcum <= (u * total)[:, None]).sum(-1).clamp(0, C - 1)
            nxt = torch.gather(cand, 1, col[:, None])[:, 0]
            # a dead end (or the pad row) has every slot at the pad
            nxt = torch.where(total > 0, nxt, cand[:, 0])
        cols.append(nxt)
        prev, cur = cur, nxt
    return torch.stack(cols, dim=1)


def gen_pair_offsets(walk_cols: int, left_win: int,
                     right_win: int) -> List[Tuple[int, int]]:
    """(center, context) column pairs of an L-column walk, clipped at
    its ends, in the reference's order (gen_pair)."""
    out = []
    for i in range(walk_cols):
        for off in range(-left_win, right_win + 1):
            j = i + off
            if off == 0 or j < 0 or j >= walk_cols:
                continue
            out.append((i, j))
    return out


def gen_pair_rows(walks: torch.Tensor, left_win: int,
                  right_win: int) -> torch.Tensor:
    """[B, L] walks → [B, P, 2] skip-gram pairs, in the reference's
    pair order, so models trained on either path are interchangeable."""
    offs = gen_pair_offsets(walks.shape[1], left_win, right_win)
    if not offs:
        return walks.new_zeros((walks.shape[0], 0, 2))
    # column slices, not an index tensor: nothing is copied from the
    # host, so a CUDA graph can capture it
    src = torch.stack([walks[:, i] for i, _ in offs], dim=1)
    dst = torch.stack([walks[:, j] for _, j in offs], dim=1)
    return torch.stack([src, dst], dim=-1)

