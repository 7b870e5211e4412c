"""GraphSAGE on device-resident tables (counterpart of
euler_tpu/models/graphsage.py:21-47, 87-193, 404-488):
`gather_feature_rows`, `_GatherEncode`, `DeviceSampledGraphSage` and
`DeviceSampledUnsupervisedSage`.

The batch carries root rows and a sample seed; neighbor sampling, the
feature gather and the label lookup read the device tables. The deepest
hop's features are read only as neighbor means, so that layer goes
through ops.gather_mean (one kernel launch per forward on CUDA) and the
[n·k, D] gathered layer is never built.

remat=True runs `_GatherEncode` under torch.utils.checkpoint, as the
reference wraps it in nn.remat: the backward pass gathers the hop
layers again instead of keeping them, so a training step launches
gather_mean twice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from euler_tpu_torch.mp_utils.base import (
    ModelOutput, SuperviseModel, ranking_loss,
)
from euler_tpu_torch.ops.gather_mean import gather_mean, take_rows
from euler_tpu_torch.parallel.device_sampler import (
    check_split_tables, sample_fanout_rows, sample_hop,
)
from euler_tpu_torch.parallel.device_walk import sample_global_rows
from euler_tpu_torch.parallel.feature_store import dequantize_rows
from euler_tpu_torch.platform import seed_words
from euler_tpu_torch.utils.encoders import SageEncoder
from euler_tpu_torch.utils.layers import Embedding

_ROADMAP_FAMILIES = "ROADMAP.md Queue A, 'Other device-resident families'"


def _check_mean(aggregator: str, model: str) -> None:
    if aggregator.lower() != "mean":
        raise NotImplementedError(
            f"aggregator {aggregator!r} in {model} is not ported yet: "
            f"{_ROADMAP_FAMILIES}")


def gather_feature_rows(batch: Dict[str, Any],
                        rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """table[rows] for each hop's rows, with jnp.take's fill semantics
    (ops.gather_mean.take_rows); with batch["feature_scale"] the int8
    rows are dequantized into the scale's dtype."""
    table = batch["feature_table"]
    scale = batch.get("feature_scale")
    out = [take_rows(table, r) for r in rows]
    if scale is None:
        return out
    return [dequantize_rows(x, scale) for x in out]


def sample_stream_seed(sample_seed: int, word: int = 17) -> int:
    """The seed of a batch's sampling stream, hashed from (word,
    sample_seed) as the reference folds sample_seed into key(word). Each
    model family has its word (its class's `stream_word`): 17 for
    DeviceSampledGraphSage, 29 for DeviceSampledUnsupervisedSage, 23
    for DeviceSampledSkipGram."""
    return seed_words(word, int(sample_seed) & 0xFFFFFFFF)


def sample_seed_generator(sample_seed: int, device: torch.device,
                          word: int = 17) -> torch.Generator:
    """The per-batch sampling stream, seeded with
    sample_stream_seed(sample_seed, word). Its bits are torch's, not
    JAX's."""
    g = torch.Generator(device=device)
    g.manual_seed(sample_stream_seed(sample_seed, word))
    return g


def batch_stream(batch: Dict[str, Any], device: torch.device,
                 word: int) -> torch.Generator:
    """A batch's sampling generator: batch["sample_generator"] when the
    caller gives one already seeded for this sample_seed (the K-step
    CUDA graph keeps its generators across batches), else a fresh one
    seeded from (word, batch["sample_seed"])."""
    gen = batch.get("sample_generator")
    if gen is None:
        gen = sample_seed_generator(batch["sample_seed"], device, word)
    return gen


def encode_fanout(encoder: SageEncoder, table: torch.Tensor,
                  scale: Optional[torch.Tensor],
                  rows: Sequence[torch.Tensor],
                  neighbor_mean: Callable = gather_mean) -> torch.Tensor:
    """The encoder over a fanout's rows [roots, hop1, ..., hopL]: hops
    0..L-1 gathered from the feature table, hop L read only as its
    neighbor mean, neighbor_mean(table, rows [n, k], scale): one
    gather_mean launch on CUDA, and the [n·k, D] layer never exists."""
    layers = gather_feature_rows(
        {"feature_table": table, "feature_scale": scale}, rows[:-1])
    n = rows[-2].shape[0]
    deepest = rows[-1].reshape(n, -1)
    return encoder(layers, nbr_mean=neighbor_mean(table, deepest, scale))


class _GatherEncode(nn.Module):
    """gather + SageEncoder ("enc"), the reference's param scope
    encoder/enc/agg_{d}/{self,nbr}."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 aggregator: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc = SageEncoder(in_dim, dim, fanouts, aggregator,
                               generator=generator)
        self.out_dim = self.enc.out_dim

    def forward(self, table: torch.Tensor, scale: Optional[torch.Tensor],
                rows: Sequence[torch.Tensor],
                neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        """rows: [roots, hop1, ..., hopL]. neighbor_mean computes the
        deepest hop's mean from (table, rows [n, k], scale); tests and
        the chip smoke substitute the plain version here."""
        return encode_fanout(self.enc, table, scale, rows, neighbor_mean)


class DeviceSampledGraphSage(SuperviseModel):
    """Fanout GraphSAGE whose sampling runs on the device.

    The batch holds rows [roots int32], sample_seed, and the tables
    (nbr_table, cum_table, feature_table, optional feature_scale,
    label_table). in_dim is the feature width (flax infers it at init).
    An optional batch["sample_uniforms"] (one [n_h, k_h] float32 tensor
    per hop) replays a draw instead of the seeded stream; an optional
    batch["sample_generator"], already seeded as sample_seed_generator
    seeds one, replaces the per-batch generator.

    Ported: encoder 'sage' with the 'mean' aggregator over replicated
    split tables, remat and dropout. The gcn/genie encoders, other
    aggregators, and the fused/alias/row-sharded layouts raise
    NotImplementedError."""

    stream_word = 17

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", encoder: str = "sage",
                 remat: bool = False, uniform_sampling: bool = False,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        if encoder not in ("sage", "gcn", "genie"):
            raise ValueError(f"DeviceSampledGraphSage.encoder must be "
                             f"'sage', 'gcn' or 'genie', got {encoder!r}")
        if encoder != "sage":
            raise NotImplementedError(
                f"encoder {encoder!r} is not ported yet: {_ROADMAP_FAMILIES}")
        _check_mean(aggregator, "DeviceSampledGraphSage")
        enc = _GatherEncode(in_dim, dim, fanouts, aggregator,
                            generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self.fanouts = tuple(int(k) for k in fanouts)
        self.uniform_sampling = bool(uniform_sampling)
        self.remat = bool(remat)
        self._spec = {"num_classes": self.num_classes,
                      "multilabel": self.multilabel, "dropout": self.dropout,
                      "table_mesh": None, "dim": int(dim),
                      "aggregator": aggregator, "encoder": encoder,
                      "remat": self.remat,
                      "uniform_sampling": self.uniform_sampling}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass fields
        (euler_tpu/models/graphsage.py:121-143), as export_bundle records
        them; table_mesh is None (replicated tables)."""
        return {"model_class": "DeviceSampledGraphSage", **self._spec}

    def sample_rows(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        """[roots, hop1, ..., hopL] int32 rows for this batch."""
        check_split_tables(batch)
        roots = batch["rows"][0]
        uniforms = batch.get("sample_uniforms")
        gen = None if uniforms is not None else batch_stream(
            batch, roots.device, self.stream_word)
        return sample_fanout_rows(batch["nbr_table"], batch["cum_table"],
                                  roots, self.fanouts, generator=gen,
                                  uniforms=uniforms,
                                  uniform=self.uniform_sampling)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        args = (batch["feature_table"], batch.get("feature_scale"),
                self.sample_rows(batch))
        if self.remat and torch.is_grad_enabled():
            # the encoder draws no random numbers (sampling is done), so
            # the recompute needs no saved RNG state
            return checkpoint(self.encoder, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return self.encoder(*args)


class DeviceSampledUnsupervisedSage(nn.Module):
    """Unsupervised GraphSAGE with its whole input path on the device:
    the fanout embedding, one positive per root (a one-neighbor draw,
    weighted or uniform) and num_negs negatives per root from the node
    sampler (parallel/device_walk.py), scored against one shared
    context table ctx_emb [num_rows + 1, dim]. Pairs whose positive is
    the pad row (roots without neighbors) are masked out of the loss
    and the MRR.

    The batch holds rows [roots int32], sample_seed, and the tables
    (nbr_table, cum_table, feature_table, optional feature_scale,
    neg_rows, neg_cum). One stream, seeded from (29, sample_seed), feeds
    in order the fanout draw, the positives and the negatives; replayed
    uniforms replace any of them: batch["sample_uniforms"] (one [n_h,
    k_h] tensor per hop), batch["pos_uniforms"] [B, 1] and
    batch["neg_uniforms"] [B, num_negs]. The deepest hop goes through
    ops.gather_mean (encode_fanout), one launch per forward on CUDA.

    Ported: the 'mean' aggregator over replicated split tables; the
    fused/alias layouts raise NotImplementedError, and row-sharded
    tables cannot be built (DeviceNeighborTable refuses them)."""

    stream_word = 29

    def __init__(self, num_rows: int, in_dim: int, dim: int = 32,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", num_negs: int = 5,
                 uniform_sampling: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_mean(aggregator, "DeviceSampledUnsupervisedSage")
        self.num_rows = int(num_rows)
        self.fanouts = tuple(int(k) for k in fanouts)
        self.num_negs = int(num_negs)
        self.uniform_sampling = bool(uniform_sampling)
        self.encoder = SageEncoder(in_dim, dim, self.fanouts, aggregator,
                                   concat=False, generator=generator)
        self.ctx_emb = Embedding(self.num_rows + 1, dim,
                                 generator=generator)
        self._spec = {"num_rows": self.num_rows, "dim": int(dim),
                      "aggregator": aggregator, "num_negs": self.num_negs,
                      "table_mesh": None,
                      "uniform_sampling": self.uniform_sampling}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass fields
        (euler_tpu/models/graphsage.py:404-424), as export_bundle records
        them."""
        return {"model_class": "DeviceSampledUnsupervisedSage", **self._spec}

    def sample(self, batch: Dict[str, Any]):
        """(fanout rows [roots, hop1, ...], positives [B], negatives
        [B, num_negs]) for this batch, drawn in that order."""
        check_split_tables(batch)
        roots = batch["rows"][0]
        replays = [batch.get(k) for k in
                   ("sample_uniforms", "pos_uniforms", "neg_uniforms")]
        gen = None if all(r is not None for r in replays) else \
            batch_stream(batch, roots.device, self.stream_word)
        nbr, cum = batch["nbr_table"], batch["cum_table"]
        rows = sample_fanout_rows(nbr, cum, roots, self.fanouts,
                                  generator=gen, uniforms=replays[0],
                                  uniform=self.uniform_sampling)
        pos = sample_hop(nbr, cum, roots, 1, generator=gen,
                         uniforms=replays[1], uniform=self.uniform_sampling)
        negs = sample_global_rows(batch["neg_rows"], batch["neg_cum"],
                                  (roots.shape[0], self.num_negs),
                                  generator=gen, uniforms=replays[2])
        return rows, pos, negs

    def forward(self, batch: Dict[str, Any]) -> ModelOutput:
        rows, pos, negs = self.sample(batch)
        emb = encode_fanout(self.encoder, batch["feature_table"],
                            batch.get("feature_scale"), rows)
        ctx = self.ctx_emb(torch.cat([pos[:, None], negs], dim=1))
        loss, metric = ranking_loss(emb, ctx, pos != self.num_rows)
        return ModelOutput(emb, loss, "mrr", metric)
