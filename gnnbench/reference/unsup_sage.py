"""Plain unsupervised GraphSAGE, Euler's: the mean-aggregator encoder
(self and neighbor transforms summed); one positive context a root (a
one-neighbor draw) and `num_negs` negatives drawn uniformly over every
node, each scored by a dot product against one context table [N+1, dim];
the sigmoid cross-entropy of the positive against 1 plus the mean of the
negatives' against 0, averaged over the roots whose positive is a real
node; dense Adam over every parameter, the context table included. The
shared step, storage types and faults are common.SageReference's (the
CPU's TF32 stand-in rounds the dense layers, not the scores' dot
products). It imports nothing of the program.

The draws come from one stream a batch, in order: the fanout, the
positives, the negatives; a negative is node ceil(u·N) - 1, the inverse
of the uniform cumulative weights 1..N.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from gnnbench.reference.common import SageReference, stream, uniform_hop

ENC = "encoder"
CTX = "ctx_emb.table"


def _bce(x: torch.Tensor, y: float) -> torch.Tensor:
    """-y·log σ(x) - (1-y)·log σ(-x), the stable form."""
    return -y * F.logsigmoid(x) - (1.0 - y) * F.logsigmoid(-x)


class Reference(SageReference):
    enc = ENC
    seed_word = 29  # the unsupervised family's sampling stream

    def __init__(self, cfg: dict, *args, **kw):
        super().__init__(cfg, *args, **kw)
        self.num_negs = int(cfg["model"]["num_negs"])

    def picks(self, batch) -> List[torch.Tensor]:
        """[roots, hop 1, hop 2, positives, negatives [B, num_negs]]."""
        roots = batch["roots"].long()
        gen = stream(self.seed_word, batch["sample_seed"], roots.device)
        layers = self.fanout(roots, gen)
        pos = uniform_hop(self.table, roots, 1, gen)
        u = torch.rand((roots.shape[0], self.num_negs), generator=gen,
                       device=roots.device, dtype=torch.float32)
        negs = (torch.ceil(u * float(self.n)).long() - 1).clamp(0, self.n - 1)
        return layers + [pos, negs]

    def loss(self, rows: List[torch.Tensor],
             m2: torch.Tensor) -> torch.Tensor:
        r0, r1, _, pos, negs = rows
        emb = self.embed(r0, r1, m2)
        ctx = self.params[CTX][torch.cat([pos[:, None], negs], dim=1)]
        scores = torch.einsum("bd,bkd->bk", emb, ctx)
        valid = (pos != self.n).to(torch.float32)
        if self.fault == "half_batch":
            valid[r0.shape[0] // 2:] = 0
        count = valid.sum().clamp_min(1.0)
        return ((_bce(scores[:, :1], 1.0).mean(-1) * valid).sum() / count
                + (_bce(scores[:, 1:], 0.0).mean(-1) * valid).sum() / count)
