"""Skip-gram embeddings (counterpart of
euler_tpu/models/embedding_models.py:24-165): the host-fed `DeepWalk`
(`Node2Vec` is the same model) and `LINE`, fed by the graph engine's
walks, pairs and edge samples (src [B], pos [B], negs [B, N] as int32
rows), and `DeviceSampledSkipGram`, DeepWalk, node2vec and LINE with the
whole input path on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch.models.graphsage import batch_stream
from euler_tpu_torch.mp_utils.base import ModelOutput, ranking_loss
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.losses import sigmoid_binary_cross_entropy
from euler_tpu_torch.parallel.device_walk import (
    gen_pair_rows, sample_global_rows, walk_rows,
)
from euler_tpu_torch.utils.layers import Embedding


def _skipgram(emb: Embedding, ctx: Embedding, batch: Dict[str, Any]
              ) -> ModelOutput:
    """src from emb, pos and negs from ctx: the sigmoid BCE of the
    positive's logit against 1 plus that of the negatives' against 0,
    each a mean, and the MRR of the positive among them."""
    src = emb(batch["src"])                          # [B, D]
    pos = ctx(batch["pos"])                          # [B, D]
    negs = ctx(batch["negs"])                        # [B, N, D]
    pos_logit = (src * pos).sum(-1, keepdim=True)
    neg_logit = torch.einsum("bd,bnd->bn", src, negs)
    loss = (sigmoid_binary_cross_entropy(
                pos_logit, torch.ones_like(pos_logit)).mean()
            + sigmoid_binary_cross_entropy(
                neg_logit, torch.zeros_like(neg_logit)).mean())
    scores = torch.cat([pos_logit, neg_logit], dim=1)
    return ModelOutput(src, loss, "mrr", M.mrr(scores))


class DeepWalk(nn.Module):
    """Skip-gram with negative sampling over the engine's walk pairs:
    emb and ctx tables [max_id + 1, dim]."""

    def __init__(self, max_id: int, dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_id, self.dim = int(max_id), int(dim)
        self.emb = Embedding(self.max_id + 1, self.dim, generator=generator)
        self.ctx = Embedding(self.max_id + 1, self.dim, generator=generator)

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "DeepWalk", "max_id": self.max_id,
                "dim": self.dim}

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        return _skipgram(self.emb, self.ctx, batch)


Node2Vec = DeepWalk  # same model; the walk's p/q bias differs (walk_ops)


class LINE(nn.Module):
    """LINE over sampled edges: order 2 scores against a context table
    ctx, order 1 against emb itself."""

    def __init__(self, max_id: int, dim: int = 128, order: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_id, self.dim, self.order = int(max_id), int(dim), int(order)
        self.emb = Embedding(self.max_id + 1, self.dim, generator=generator)
        self.ctx = None if self.order == 1 else Embedding(
            self.max_id + 1, self.dim, generator=generator)

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "LINE", "max_id": self.max_id,
                "dim": self.dim, "order": self.order}

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        return _skipgram(self.emb,
                         self.emb if self.ctx is None else self.ctx, batch)


class DeviceSampledSkipGram(nn.Module):
    """Skip-gram with negative sampling over walks drawn on the device.

    walk_len and the window (left_win, right_win) give DeepWalk; p and q
    give node2vec's second-order bias; walk_len 1 with window (0, 1) is
    LINE, second order with a separate context table (the default),
    first order with share_context=True. Each root's walk
    (device_walk.walk_rows over the neighbor table) gives its skip-gram
    pairs (gen_pair_rows, in the reference's order), and each pair
    num_negs negatives from the node sampler. The source embeds from
    `emb` [num_rows + 1, dim], the positive and the negatives from `ctx`
    (or `emb` with share_context). Pairs that touch the pad row (walks
    that hit a dead end) are masked out of the loss and the MRR. The
    output embedding is emb(roots).

    The batch holds rows [roots int32], sample_seed and the tables
    (nbr_table, cum_table, neg_rows, neg_cum). One stream, seeded from
    (23, sample_seed), feeds in order the walk's steps and the
    negatives; replayed uniforms replace them: batch["walk_uniforms"]
    (one [B] tensor per step, [2, B] for an alias step) and
    batch["neg_uniforms"] [B·P, num_negs]. uniform_sampling (unit-weight
    tables) takes the one-gather draw for the p = q = 1 steps; an
    alias_table in the batch takes the alias draw there instead, as the
    reference's does. The walk reads the split tables: a fused table
    alone has no nbr_table, and the batch raises KeyError, as the
    reference's does."""

    stream_word = 23

    def __init__(self, num_rows: int, dim: int = 128, walk_len: int = 5,
                 left_win: int = 1, right_win: int = 1, num_negs: int = 5,
                 p: float = 1.0, q: float = 1.0, share_context: bool = False,
                 uniform_sampling: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_rows = int(num_rows)
        self.walk_len = int(walk_len)
        self.left_win, self.right_win = int(left_win), int(right_win)
        self.num_negs = int(num_negs)
        self.p, self.q = float(p), float(q)
        self.uniform_sampling = bool(uniform_sampling)
        self.emb = Embedding(self.num_rows + 1, dim, generator=generator)
        self.ctx = None if share_context else Embedding(
            self.num_rows + 1, dim, generator=generator)
        self._spec = {"num_rows": self.num_rows, "dim": int(dim),
                      "walk_len": self.walk_len, "left_win": self.left_win,
                      "right_win": self.right_win, "num_negs": self.num_negs,
                      "p": self.p, "q": self.q,
                      "share_context": bool(share_context),
                      "table_mesh": None,
                      "uniform_sampling": self.uniform_sampling}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass fields
        (euler_tpu/models/embedding_models.py:53-90), as export_bundle
        records them."""
        return {"model_class": "DeviceSampledSkipGram", **self._spec}

    def sample(self, batch: Dict[str, Any]):
        """(pairs [B·P, 2] rows (source, positive), negatives [B·P,
        num_negs]) for this batch, the walks drawn before the
        negatives."""
        roots = batch["rows"][0]
        replays = [batch.get("walk_uniforms"), batch.get("neg_uniforms")]
        gen = None if all(r is not None for r in replays) else \
            batch_stream(batch, roots.device, self.stream_word)
        walks = walk_rows(batch["nbr_table"], batch["cum_table"], roots,
                          self.walk_len, generator=gen, uniforms=replays[0],
                          p=self.p, q=self.q, uniform=self.uniform_sampling,
                          alias_table=batch.get("alias_table"))
        pairs = gen_pair_rows(walks, self.left_win, self.right_win)
        pairs = pairs.reshape(-1, 2)
        negs = sample_global_rows(batch["neg_rows"], batch["neg_cum"],
                                  (pairs.shape[0], self.num_negs),
                                  generator=gen, uniforms=replays[1])
        return pairs, negs

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        pairs, negs = self.sample(batch)
        src_r, pos_r = pairs[:, 0], pairs[:, 1]
        ctx_table = self.emb if self.ctx is None else self.ctx
        src = self.emb(src_r)
        ctx = ctx_table(torch.cat([pos_r[:, None], negs], dim=1))
        pad = self.num_rows
        loss, metric = ranking_loss(src, ctx, (src_r != pad) & (pos_r != pad))
        return ModelOutput(self.emb(batch["rows"][0]), loss, "mrr", metric)
