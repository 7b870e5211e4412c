"""GEMM FLOPs of one GeniePath training step, counted from shapes.

The step (reference/geniepath.py has its equations) over a fanout of
hops 0 .. L, n_l = batch · k_1 ⋯ k_l rows at hop l, width `dim`:
- the projection h_l = P x_l + p of every hop's features (in_dim wide);
- depth t = 0 .. L-1, hop l = 0 .. L-1-t: the attention keys over the
  node and its k_{l+1} neighbours (n_l · (k_{l+1} + 1) rows), the pool's
  two products a row (the logits q · tanh(·) and the weighted sum
  Σ_j a_j S_j, each dim multiply-adds), the transform W_{t,l} over the
  n_l pooled rows;
- depth_fc_0 .. depth_fc_L over the roots;
- the LSTM over the L + 1 depth states of the roots: per step one input
  and one recurrent GEMM of 4·dim outputs;
- the head of `classes` logits.
Forward and backward, nothing recomputed: a dense layer whose input
takes no gradient (the projection: its input is the features) counts 2
passes, every other layer 3 (counts.dense_flops). The softmax, tanh,
the LSTM's gates and the loss are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence

from gnnbench.yardstick.counts import _prod, dense_flops


def genie_step_flops(batch: int, fanouts: Sequence[int], in_dim: int,
                     dim: int, classes: int) -> Dict[str, int]:
    """{part: FLOPs} of one step, and "total"."""
    hops = len(fanouts)
    rows = [batch * _prod(fanouts[:h]) for h in range(hops + 1)]
    keys = [sum(rows[h] * (int(fanouts[h]) + 1) for h in range(hops - t))
            for t in range(hops)]
    pooled = sum(rows[h] for t in range(hops) for h in range(hops - t))
    out = {
        "projection": dense_flops(sum(rows), in_dim, dim, 2),
        "depth0_keys": dense_flops(keys[0], dim, dim, 3),
        "deeper_keys": sum(dense_flops(n, dim, dim, 3) for n in keys[1:]),
        "transforms": dense_flops(pooled, dim, dim, 3),
        "depth_fc": (hops + 1) * dense_flops(batch, dim, dim, 3),
        "lstm": (hops + 1) * 2 * dense_flops(batch, dim, 4 * dim, 3),
        "head": dense_flops(batch, dim, classes, 3),
        # two dim-long products a key row, forward and both gradients
        "pooling": 2 * 2 * sum(keys) * dim * 3,
    }
    out["total"] = sum(out.values())
    return out
