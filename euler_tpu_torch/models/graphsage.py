"""GraphSAGE on device-resident tables (counterpart of
euler_tpu/models/graphsage.py:21-47, 87-193): `gather_feature_rows`,
`_GatherEncode` and `DeviceSampledGraphSage`.

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

from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.ops.gather_mean import gather_mean, take_rows
from euler_tpu_torch.parallel.device_sampler import (
    _ROADMAP_LAYOUTS, sample_fanout_rows,
)
from euler_tpu_torch.parallel.feature_store import dequantize_rows
from euler_tpu_torch.platform import seed_words
from euler_tpu_torch.utils.encoders import SageEncoder


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


def sample_stream_seed(sample_seed: int) -> int:
    """The seed of a batch's sampling stream, hashed from (17,
    sample_seed) as the reference folds sample_seed into key(17)."""
    return seed_words(17, int(sample_seed) & 0xFFFFFFFF)


def sample_seed_generator(sample_seed: int,
                          device: torch.device) -> torch.Generator:
    """The per-batch sampling stream, seeded with
    sample_stream_seed(sample_seed). Its bits are torch's, not JAX's."""
    g = torch.Generator(device=device)
    g.manual_seed(sample_stream_seed(sample_seed))
    return g


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
        layers = gather_feature_rows(
            {"feature_table": table, "feature_scale": scale}, rows[:-1])
        n = rows[-2].shape[0]
        deepest = rows[-1].reshape(n, -1)
        return self.enc(layers, nbr_mean=neighbor_mean(table, deepest, scale))


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
                f"encoder {encoder!r} is not ported yet: ROADMAP.md "
                "Queue A, 'Other device-resident families'")
        if aggregator.lower() != "mean":
            raise NotImplementedError(
                f"aggregator {aggregator!r} in DeviceSampledGraphSage is "
                "not ported yet: ROADMAP.md Queue A, 'Other "
                "device-resident families'")
        enc = _GatherEncode(in_dim, dim, fanouts, aggregator,
                            generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self.fanouts = tuple(int(k) for k in fanouts)
        self.uniform_sampling = bool(uniform_sampling)
        self.remat = bool(remat)

    def sample_rows(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        """[roots, hop1, ..., hopL] int32 rows for this batch."""
        if batch.get("nbrcum_table") is not None \
                or batch.get("alias_table") is not None:
            raise NotImplementedError(
                f"fused/alias tables are {_ROADMAP_LAYOUTS}")
        roots = batch["rows"][0]
        uniforms = batch.get("sample_uniforms")
        gen = None
        if uniforms is None:
            # a generator that outlives the batch (the K-step CUDA graph
            # captures it) comes already seeded for this sample_seed
            gen = batch.get("sample_generator")
            if gen is None:
                gen = sample_seed_generator(batch["sample_seed"],
                                            roots.device)
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
