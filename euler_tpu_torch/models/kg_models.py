"""Knowledge-graph embedding models: TransE, TransH, TransR, TransD and
DistMult (counterpart of euler_tpu/models/kg_models.py).

A batch holds positive triples h [B], r [B], t [B] (entity and relation
ids) and corrupted tails neg_t [B, N]. The loss is the margin ranking
loss mean(max(0, margin - pos + neg)), the metric the MRR of the
positive among its N corruptions. Parameter modules keep the
reference's names (ent, rel, norm, proj, rel_p, ent_p; each an
Embedding with its "table"), so euler_tpu_torch.convert maps the trees.

The translation scores are minus the L1 norm (norm_ord 1, the default)
of h + r - t after the model's projection. jnp.linalg.norm's L1 norm
is the sum of jnp.abs, whose gradient at an exact 0 is +1 (it selects
x where x >= 0, else -x); torch's abs gives 0 there. `_abs` follows the
reference, so a component of h + r - t that is exactly 0 gets the
reference's gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from euler_tpu_torch.mp_utils.base import ModelOutput
from euler_tpu_torch.utils import metrics as M
from euler_tpu_torch.utils.layers import Embedding


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient is +1 at x == 0 (jnp.abs's), -1 below."""
    return torch.where(x >= 0, x, -x)


def vector_norm(x: torch.Tensor, ord: int = 1) -> torch.Tensor:
    """jnp.linalg.norm(x, ord, axis=-1) of a vector, with its gradient:
    ord 1 the sum of `_abs`; ord 2 the square root of the sum of
    squares; another ord the ord-th root of the sum of |x|^ord."""
    if ord == 1:
        return _abs(x).sum(-1)
    if ord == 2:
        return torch.sqrt((x * x).sum(-1))
    return (_abs(x) ** ord).sum(-1) ** (1.0 / ord)


class _KGBase(nn.Module):
    """Shared: the entity table "ent" [num_entities, dim], the scorer's
    own tables (build_tables), the margin loss and the MRR."""

    def __init__(self, num_entities: int = 0, num_relations: int = 0,
                 dim: int = 64, margin: float = 1.0, norm_ord: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_entities = int(num_entities)
        self.num_relations = int(num_relations)
        self.dim = int(dim)
        self.margin = float(margin)
        self.norm_ord = int(norm_ord)
        self.ent = Embedding(self.num_entities, self.dim,
                             generator=generator)
        self.build_tables(generator)

    def build_tables(self, generator: Optional[torch.Generator]) -> None:
        self.rel = Embedding(self.num_relations, self.dim,
                             generator=generator)

    def score(self, h: torch.Tensor, r_idx: torch.Tensor, t: torch.Tensor,
              h_ids: torch.Tensor, t_ids: torch.Tensor) -> torch.Tensor:
        """Higher = more plausible. h, t: [..., D] entity embeddings;
        r_idx, h_ids, t_ids: [...] ids."""
        raise NotImplementedError

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        h_ids, t_ids, r = batch["h"], batch["t"], batch["r"]
        neg_t_ids = batch["neg_t"]
        h = self.ent(h_ids)                                  # [B, D]
        t = self.ent(t_ids)
        neg_t = self.ent(neg_t_ids)                          # [B, N, D]
        pos = self.score(h, r, t, h_ids, t_ids)[:, None]
        neg = self.score(h[:, None, :], r[:, None], neg_t,
                         h_ids[:, None], neg_t_ids)           # [B, N]
        loss = torch.clamp(self.margin - pos + neg, min=0.0).mean()
        scores = torch.cat([pos, neg], dim=1)
        return ModelOutput(h, loss, "mrr", M.mrr(scores))


class TransE(_KGBase):
    """score = -||h + r - t||."""

    def score(self, h, r_idx, t, h_ids=None, t_ids=None):
        return -vector_norm(h + self.rel(r_idx) - t, self.norm_ord)


class TransH(_KGBase):
    """h and t projected onto the relation's hyperplane (its unit normal
    from "norm", the norm at least 1e-12), then translated."""

    def build_tables(self, generator):
        self.rel = Embedding(self.num_relations, self.dim,
                             generator=generator)
        self.norm = Embedding(self.num_relations, self.dim,
                              generator=generator)

    def score(self, h, r_idx, t, h_ids=None, t_ids=None):
        r = self.rel(r_idx)
        w = self.norm(r_idx)
        w = w / torch.clamp(vector_norm(w, 2)[..., None], min=1e-12)
        h_p = h - (h * w).sum(-1, keepdim=True) * w
        t_p = t - (t * w).sum(-1, keepdim=True) * w
        return -vector_norm(h_p + r - t_p, self.norm_ord)


class TransR(_KGBase):
    """A projection matrix per relation: "proj" rows of dim·dim, as
    [..., dim, dim]."""

    def build_tables(self, generator):
        self.rel = Embedding(self.num_relations, self.dim,
                             generator=generator)
        self.proj = Embedding(self.num_relations, self.dim * self.dim,
                              generator=generator)

    def score(self, h, r_idx, t, h_ids=None, t_ids=None):
        r = self.rel(r_idx)
        m = self.proj(r_idx).reshape(*r_idx.shape, self.dim, self.dim)
        h_p = torch.einsum("...d,...de->...e", h, m)
        t_p = torch.einsum("...d,...de->...e", t, m)
        return -vector_norm(h_p + r - t_p, self.norm_ord)


class TransD(_KGBase):
    """Dynamic rank-1 projection: h_p = h + (w_h · h) w_r, with the
    entity vectors "ent_p" and the relation vectors "rel_p"."""

    def build_tables(self, generator):
        self.rel = Embedding(self.num_relations, self.dim,
                             generator=generator)
        self.rel_p = Embedding(self.num_relations, self.dim,
                               generator=generator)
        self.ent_p = Embedding(self.num_entities, self.dim,
                               generator=generator)

    def score(self, h, r_idx, t, h_ids=None, t_ids=None):
        r = self.rel(r_idx)
        w_r = self.rel_p(r_idx)
        w_h = self.ent_p(h_ids)
        w_t = self.ent_p(t_ids)
        h_p = h + (w_h * h).sum(-1, keepdim=True) * w_r
        t_p = t + (w_t * t).sum(-1, keepdim=True) * w_r
        return -vector_norm(h_p + r - t_p, self.norm_ord)


class DistMult(_KGBase):
    """score = <h, r, t>, the trilinear product."""

    def score(self, h, r_idx, t, h_ids=None, t_ids=None):
        return (h * self.rel(r_idx) * t).sum(-1)
