"""Plain supervised GraphSAGE: GraphSAGE-mean (Hamilton et al. 2017),
concatenated self and neighbor transforms, a dense head of
`num_classes` logits, softmax cross-entropy averaged over the batch, and
Adam; the shared step, storage types and faults are
common.SageReference's. It imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from gnnbench.reference.common import SageReference, stream

ENC = "encoder.enc"


class Reference(SageReference):
    enc = ENC
    seed_word = 17  # the supervised family's sampling stream

    def picks(self, batch) -> List[torch.Tensor]:
        """[roots, hop 1, hop 2] rows of the batch's draw."""
        roots = batch["roots"].long()
        return self.fanout(roots, stream(self.seed_word,
                                         batch["sample_seed"], roots.device))

    def loss(self, rows: List[torch.Tensor],
             m2: torch.Tensor) -> torch.Tensor:
        emb = self.embed(rows[0], rows[1], m2)
        p = self.params
        logits = F.linear(emb, p["out.weight"], p["out.bias"])
        per_row = F.cross_entropy(logits, self.labels[rows[0]],
                                  reduction="none")
        if self.fault == "half_batch":
            per_row = per_row[: rows[0].shape[0] // 2]
        return per_row.mean()
