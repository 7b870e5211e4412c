"""GraphSAGE models (counterpart of euler_tpu/models/graphsage.py:21-85,
87-488, 513-528): `gather_feature_rows`, `_fanout_layers`,
`SupervisedGraphSage`, `UnsupervisedGraphSage` and `ScalableGraphSage`
(host-fed),
`_GatherEncode`, `DeviceSampledGraphSage`, `DeviceSampledScalableSage`
with `refresh_act_cache`, `DeviceSampledLayerwiseGCN` and
`DeviceSampledUnsupervisedSage`.

The host-fed models read each hop's features from the batch: "layers"
shipped from the host (the engine's features), or "rows" gathered from
the device feature table (a DeviceFeatureStore; an int8 table is
dequantized after the gather). Their SageEncoder takes a plain mean over
every hop's rows, as the reference's does: no kernel.

The device-sampled models' batch carries root rows and a sample seed;
neighbor sampling, the feature gather and the label lookup read the
device tables. The neighbor tables come in the reference's three
layouts (split, fused, and split with an alias table;
parallel/device_sampler.py) and the models pick the draw as the
reference does: a fused table selects the fused draw, an alias table
wins over uniform_sampling.

Wherever the reference reduces the deepest hop with a plain mean over
gathered rows, that hop goes through ops.gather_mean (one kernel launch
on CUDA) and its [n·k, D] layer is never built: the sage encoder with
the mean aggregator, the gcn encoder ((x + k·mean) / (k + 1)), and both
neighbor reads of the scalable model (the feature rows of layer 0, the
cache rows of layer 1 and up; the host-fed ScalableGraphSage reads its
cache rows so too). The genie encoder and the pool
aggregators transform each neighbor before pooling, so they gather the
deepest hop with take_rows.

remat=True runs `_GatherEncode` under torch.utils.checkpoint, as the
reference wraps it in nn.remat: the backward pass gathers the hop
layers again instead of keeping them, so a training step launches
gather_mean twice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from euler_tpu_torch.mp_utils.base import (
    ModelOutput, SuperviseModel, UnsuperviseModel, ranking_loss,
)
from euler_tpu_torch.ops.gather_mean import gather_mean, take_rows
from euler_tpu_torch.parallel.device_layerwise import sample_layerwise_rows
from euler_tpu_torch.parallel.device_sampler import (
    sample_hop, sample_hop_fused,
)
from euler_tpu_torch.parallel.device_walk import sample_global_rows
from euler_tpu_torch.parallel.feature_store import dequantize_rows
from euler_tpu_torch.platform import seed_words
from euler_tpu_torch.utils.encoders import (
    GCNEncoder, GenieEncoder, LayerEncoder, SageEncoder,
    ScalableGCNEncoder, ScalableSageEncoder,
)
from euler_tpu_torch.utils.layers import Embedding


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


def _fanout_layers(batch: Dict[str, Any]) -> List[torch.Tensor]:
    """Per-hop feature tensors from either host batch geometry:
    "layers" (features shipped from the host) or "rows" gathered from
    the device feature table."""
    layers = batch.get("layers")
    if layers is not None:
        return layers
    return gather_feature_rows(batch, batch["rows"])


class SupervisedGraphSage(SuperviseModel):
    """Fanout batch {"layers": [x0..xL]} (or "rows" + the device feature
    table) → SageEncoder ("encoder") → logits, the reference's host-fed
    model (bench.py --host_sampler's). in_dim is the feature width
    (flax infers it at init)."""

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        enc = SageEncoder(in_dim, dim, fanouts, aggregator,
                          generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self._spec = {"num_classes": self.num_classes,
                      "multilabel": self.multilabel, "dropout": self.dropout,
                      "table_mesh": None, "dim": int(dim),
                      "aggregator": aggregator}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "SupervisedGraphSage", **self._spec}

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.encoder(_fanout_layers(batch))


class UnsupervisedGraphSage(UnsuperviseModel):
    """Fanout batch + pos/negs ids → the sage embedding (concat=False)
    against the context table ctx_emb [max_id + 1, dim], the reference's
    host-fed model (EdgeEstimator's)."""

    def __init__(self, in_dim: int, dim: int, max_id: int,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", num_negs: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim, max_id, num_negs, generator=generator)
        self.encoder = SageEncoder(in_dim, dim, fanouts, aggregator,
                                   concat=False, generator=generator)
        self._spec = {"dim": self.dim, "max_id": self.max_id,
                      "num_negs": self.num_negs, "aggregator": aggregator}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "UnsupervisedGraphSage", **self._spec}

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.encoder(_fanout_layers(batch))


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


def encode_fanout(encoder: nn.Module, table: torch.Tensor,
                  scale: Optional[torch.Tensor],
                  rows: Sequence[torch.Tensor],
                  neighbor_mean: Callable = gather_mean) -> torch.Tensor:
    """The encoder over a fanout's rows [roots, hop1, ..., hopL]. A sage
    encoder with the mean aggregator, or a gcn encoder, reads hop L only
    as its neighbor mean, neighbor_mean(table, rows [n, k], scale): one
    gather_mean launch on CUDA, and the [n·k, D] layer never exists.
    Any other encoder gets every hop gathered with take_rows."""
    batch = {"feature_table": table, "feature_scale": scale}
    gcn = isinstance(encoder, GCNEncoder)
    if not (gcn or (isinstance(encoder, SageEncoder)
                    and encoder.aggregator == "mean")):
        return encoder(gather_feature_rows(batch, rows))
    layers = gather_feature_rows(batch, rows[:-1])
    deepest = rows[-1].reshape(rows[-2].shape[0], -1)
    m = neighbor_mean(table, deepest, scale)
    if gcn:
        return encoder(layers, nbr_mean=m, nbr_count=deepest.shape[1])
    return encoder(layers, nbr_mean=m)


_ENCODERS = {"sage": SageEncoder, "gcn": GCNEncoder, "genie": GenieEncoder}


class _GatherEncode(nn.Module):
    """gather + the fanout encoder ("enc": SageEncoder, GCNEncoder or
    GenieEncoder), the reference's param scope encoder/enc/..."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 aggregator: str, encoder: str = "sage",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if encoder == "sage":
            self.enc = SageEncoder(in_dim, dim, fanouts, aggregator,
                                   generator=generator)
        else:
            self.enc = _ENCODERS[encoder](in_dim, dim, fanouts,
                                          generator=generator)
        self.out_dim = self.enc.out_dim

    def forward(self, table: torch.Tensor, scale: Optional[torch.Tensor],
                rows: Sequence[torch.Tensor],
                neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        """rows: [roots, hop1, ..., hopL]. neighbor_mean computes the
        deepest hop's mean from (table, rows [n, k], scale); tests and
        the chip smoke substitute the plain version here."""
        return encode_fanout(self.enc, table, scale, rows, neighbor_mean)


def sample_one_hop(batch: Dict[str, Any], rows: torch.Tensor, count: int,
                   generator: Optional[torch.Generator],
                   uniforms: Optional[torch.Tensor],
                   uniform_sampling: bool) -> torch.Tensor:
    """One hop of the draw over whichever layout the batch holds, [n] →
    [n * count], with the reference's precedence: nbrcum_table → the
    fused draw; else the split tables, alias_table → the alias draw (it
    wins over uniform_sampling)."""
    fused = batch.get("nbrcum_table")
    if fused is not None:
        return sample_hop_fused(fused, rows, count, generator=generator,
                                uniforms=uniforms)
    atab = batch.get("alias_table")
    return sample_hop(batch["nbr_table"], batch["cum_table"], rows, count,
                      generator=generator, uniforms=uniforms,
                      uniform=uniform_sampling and atab is None,
                      alias_table=atab)


def sample_layers(batch: Dict[str, Any], roots: torch.Tensor,
                  fanouts: Sequence[int],
                  generator: Optional[torch.Generator],
                  uniforms: Optional[Sequence[torch.Tensor]],
                  uniform_sampling: bool) -> List[torch.Tensor]:
    """The fanout draw [roots, hop1, ...]: sample_one_hop hop by hop,
    each hop drawing from `generator` in hop order or replaying its
    uniforms tensor."""
    if uniforms is not None and len(uniforms) != len(fanouts):
        raise ValueError(f"need one uniforms tensor per hop "
                         f"({len(fanouts)}), got {len(uniforms)}")
    layers = [roots]
    for h, k in enumerate(fanouts):
        layers.append(sample_one_hop(
            batch, layers[-1], int(k), generator,
            None if uniforms is None else uniforms[h], uniform_sampling))
    return layers


class DeviceSampledGraphSage(SuperviseModel):
    """Fanout GraphSAGE whose sampling runs on the device.

    The batch holds rows [roots int32], sample_seed, and the tables
    (nbr_table and cum_table with an optional alias_table, or
    nbrcum_table; feature_table, optional feature_scale, label_table).
    in_dim is the feature width (flax infers it at init). An optional
    batch["sample_uniforms"] (one float32 tensor per hop: [n_h, k_h],
    or [2, n_h, k_h] for the alias draw) replays a draw instead of the
    seeded stream; an optional batch["sample_generator"], already
    seeded as sample_seed_generator seeds one, replaces the per-batch
    generator.

    encoder: 'sage' (with the aggregator: mean, meanpool or maxpool;
    'gcn' raises TypeError in SageEncoder, as the reference's does),
    'gcn' or 'genie'. Row-sharded tables are not ported yet
    (DeviceNeighborTable refuses them)."""

    stream_word = 17

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", encoder: str = "sage",
                 remat: bool = False, uniform_sampling: bool = False,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        if encoder not in _ENCODERS:
            raise ValueError(f"DeviceSampledGraphSage.encoder must be "
                             f"'sage', 'gcn' or 'genie', got {encoder!r}")
        enc = _GatherEncode(in_dim, dim, fanouts, aggregator, encoder,
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
        roots = batch["rows"][0]
        uniforms = batch.get("sample_uniforms")
        gen = None if uniforms is not None else batch_stream(
            batch, roots.device, self.stream_word)
        return sample_layers(batch, roots, self.fanouts, gen, uniforms,
                             self.uniform_sampling)

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        args = (batch["feature_table"], batch.get("feature_scale"),
                self.sample_rows(batch))
        if self.remat and torch.is_grad_enabled():
            # the encoder draws no random numbers (sampling is done), so
            # the recompute needs no saved RNG state
            return checkpoint(self.encoder, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return self.encoder(*args)


_SCALABLE = {"sage": ScalableSageEncoder, "gcn": ScalableGCNEncoder}


class DeviceSampledScalableSage(SuperviseModel):
    """Historical-activation GraphSAGE with sampling and the activation
    cache on the device (counterpart of
    euler_tpu/models/graphsage.py:196-264): one sampled hop of `fanout`
    neighbors; layer 0 reads the neighbors' feature rows, layer l >= 1
    their rows of the cache encoder.cache_{l}.h [max_id + 1, dim]
    (float32, or cache_dtype=torch.bfloat16), both as one gather_mean
    launch each on CUDA: num_layers launches a forward.

    The caches are what the reference keeps in its `cache` collection:
    module buffers, in the state_dict (checkpoints, keep_best), no
    parameters. Training writes the batch's rows (`_ScalableCache`),
    evaluate and infer only read them, and a step the nonfinite guard
    skips leaves them as they were (the estimator calls
    `settle_cache_writes`). `refresh_act_cache` writes every row.

    The batch is DeviceSampledGraphSage's, with one hop: an optional
    batch["sample_uniforms"] holds one tensor, [B, fanout] (or [2, B,
    fanout] for the alias draw). Its stream word is 17, as the
    reference's key(17)."""

    stream_word = 17

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32, fanout: int = 10,
                 num_layers: int = 2, max_id: int = 0,
                 cache_dtype: Optional[torch.dtype] = None,
                 store_decay: float = 0.9, encoder: str = "sage",
                 uniform_sampling: bool = False, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        if encoder not in _SCALABLE:
            raise ValueError(
                f"DeviceSampledScalableSage.encoder must be 'sage' or "
                f"'gcn', got {encoder!r}")
        enc = _SCALABLE[encoder](in_dim, dim, num_layers, max_id,
                                 store_decay=store_decay,
                                 cache_dtype=cache_dtype or torch.float32,
                                 generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self.fanout = int(fanout)
        self.uniform_sampling = bool(uniform_sampling)
        # refresh_act_cache writes the caches outside training
        self.refreshing = False
        self._spec = {"num_classes": self.num_classes,
                      "multilabel": self.multilabel, "dropout": self.dropout,
                      "table_mesh": None, "dim": int(dim),
                      "fanout": self.fanout, "num_layers": int(num_layers),
                      "max_id": int(max_id), "store_decay": float(store_decay),
                      "encoder": encoder,
                      "uniform_sampling": self.uniform_sampling}
        if cache_dtype is None:
            # the reference records a None cache_dtype; a dtype is no
            # scalar and is left out, as there
            self._spec["cache_dtype"] = None

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass fields
        (euler_tpu/models/graphsage.py:196-264), as export_bundle records
        them."""
        return {"model_class": "DeviceSampledScalableSage", **self._spec}

    def sample_rows(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The one hop's neighbor rows [B, fanout] int32."""
        roots = batch["rows"][0]
        uniforms = batch.get("sample_uniforms")
        gen = None if uniforms is not None else batch_stream(
            batch, roots.device, self.stream_word)
        nbr = sample_one_hop(batch, roots, self.fanout, gen,
                             None if uniforms is None else uniforms[0],
                             self.uniform_sampling)
        return nbr.reshape(roots.shape[0], self.fanout)

    def embed(self, batch: Dict[str, Any],
              neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        roots = batch["rows"][0]
        nbr = self.sample_rows(batch)
        table, scale = batch["feature_table"], batch.get("feature_scale")
        x = gather_feature_rows(batch, [roots])[0]
        return self.encoder(roots, x, nbr, neighbor_mean(table, nbr, scale),
                            write=self.training or self.refreshing,
                            neighbor_mean=neighbor_mean)

    def settle_cache_writes(self, skip: Optional[torch.Tensor]) -> None:
        """After a training step's guard: skip (1.0 on a skipped step,
        a device scalar; None without the guard) puts the step's cache
        writes back."""
        for cache in self.encoder.caches():
            cache.settle(skip)


class ScalableGraphSage(SuperviseModel):
    """Host-fed historical-activation GraphSAGE (counterpart of
    euler_tpu/models/graphsage.py:ScalableGraphSage): the host flow's one
    hop (FanoutDataFlow with one fanout) feeds ScalableSageEncoder
    ("encoder"): the roots ids[0] with their features layers[0], and
    their k neighbors ids[1] / layers[1] as [B, k]. Layer 0 takes the
    mean of the neighbors' features; layer l >= 1 reads their rows of
    the float32 cache encoder.cache_{l}.h [max_id + 1, dim], one
    gather_mean launch on CUDA (num_layers - 1 launches a forward).
    Training writes the roots' rows, as DeviceSampledScalableSage's
    caches do (buffers in the state_dict, settled after the guard)."""

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32,
                 num_layers: int = 2, max_id: int = 0,
                 store_decay: float = 0.9, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        enc = ScalableSageEncoder(in_dim, dim, num_layers, max_id,
                                  store_decay=store_decay,
                                  generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self._spec = {"num_classes": self.num_classes,
                      "multilabel": self.multilabel, "dropout": self.dropout,
                      "table_mesh": None, "dim": int(dim),
                      "num_layers": int(num_layers), "max_id": int(max_id)}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "ScalableGraphSage", **self._spec}

    def embed(self, batch: Dict[str, Any],
              neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        ids, layers = batch["ids"], batch["layers"]
        root, x = ids[0], layers[0]
        b = root.shape[0]
        nbr_ids = ids[1].reshape(b, -1)
        nbr_x = layers[1].reshape(b, nbr_ids.shape[1], -1)
        return self.encoder(root, x, nbr_ids, nbr_x.mean(1),
                            write=self.training,
                            neighbor_mean=neighbor_mean)

    def settle_cache_writes(self, skip: Optional[torch.Tensor]) -> None:
        """After a training step's guard: skip (1.0 on a skipped step)
        puts the step's cache writes back."""
        for cache in self.encoder.caches():
            cache.settle(skip)


def refresh_act_cache(est, n_rows: Optional[int] = None, chunk: int = 8192,
                      seed: int = 1) -> None:
    """Write every row of a DeviceSampledScalableSage estimator's caches:
    the model's forward over all table rows in chunks, the caches
    written, no dropout and no gradient; then the trailing pad row is
    zeroed again, so padded neighbor slots keep reading zeros
    (counterpart of euler_tpu/models/graphsage.py:refresh_act_cache).
    Chunk i draws from sample_seed seed·1,000,003 + i; the last chunk's
    tail repeats the last real row. Install as
    `est.pre_eval_hook = refresh_act_cache`."""
    from euler_tpu_torch.estimator.infer import eval_mode

    model = est.model
    if not isinstance(model, DeviceSampledScalableSage) \
            or not model.encoder.caches():
        return
    if n_rows is None:
        n_rows = int(est.static_batch["feature_table"].shape[0])
    live = n_rows - 1  # rows 0..live-1 are real nodes; row live is pad
    chunk = max(1, min(chunk, live))
    dev = est.device
    base = dict(est.static_batch)
    model.refreshing = True
    try:
        with eval_mode(model), torch.no_grad():
            for i, lo in enumerate(range(0, live, chunk)):
                rows = np.minimum(np.arange(lo, lo + chunk), live - 1)
                batch = {**base,
                         "rows": [torch.from_numpy(
                             rows.astype(np.int32)).to(dev)],
                         "sample_seed": np.uint32(seed * 1_000_003 + i)}
                model.embed(batch)
            for cache in model.encoder.caches():
                cache.staged = None
                cache.h[live] = 0
    finally:
        model.refreshing = False


class DeviceSampledLayerwiseGCN(SuperviseModel):
    """FastGCN/LADIES with its sampling on the device (counterpart of
    euler_tpu/models/graphsage.py:355-401): per-layer pools, the dense
    adjacency between levels (parallel/device_layerwise.py) and the
    feature rows of every level (gather_feature_rows: take_rows and the
    int8 dequant; no neighbor mean, so no gather_mean) from the device
    tables, then LayerEncoder ("encoder", Dense w_{i}). The batch holds
    rows [roots int32], sample_seed and the tables, as
    DeviceSampledGraphSage's; its sampling stream is seeded from (31,
    sample_seed), as the reference's key(31). An optional
    batch["sample_uniforms"] (one tensor per layer: [m_l], or [3, m_l]
    with an alias table) replays a draw.

    A host-built batch ("layers" and "adjs", NodeEstimator's
    eval_via_flow) goes straight to the encoder: the FastGCN protocol
    evaluates on exact 1-hop closures. A fused-only batch raises
    ValueError (the pool weights come from the cum rows), as the
    reference's does; row-sharded tables (table_mesh) are not ported.
    layer_dropout: LayerEncoder's input dropout per layer; dropout:
    SuperviseModel's, on the embedding."""

    stream_word = 31

    def __init__(self, num_classes: int, in_dim: int,
                 multilabel: bool = True, dim: int = 32,
                 layer_sizes: Sequence[int] = (128, 128),
                 layer_dropout: float = 0.0, dropout: float = 0.0,
                 table_mesh=None,
                 generator: Optional[torch.Generator] = None):
        if table_mesh is not None:
            raise NotImplementedError(
                "row-sharded tables for device layerwise sampling are "
                "not ported yet: ROADMAP.md Queue A, 'Multi-GPU'")
        self.layer_sizes = tuple(int(m) for m in layer_sizes)
        enc = LayerEncoder(in_dim, dim, len(self.layer_sizes),
                           dropout=layer_dropout, generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.encoder = enc
        self._spec = {"num_classes": self.num_classes,
                      "multilabel": self.multilabel, "dropout": self.dropout,
                      "table_mesh": None, "dim": int(dim),
                      "layer_dropout": float(layer_dropout)}

    def export_spec(self) -> Dict[str, Any]:
        """The reference model's class name and scalar dataclass
        fields."""
        return {"model_class": "DeviceSampledLayerwiseGCN", **self._spec}

    def sample_levels(self, batch: Dict[str, Any]):
        """(levels, adjs) of this batch's layerwise draw."""
        if batch.get("nbrcum_table") is not None:
            raise ValueError(
                "DeviceSampledLayerwiseGCN needs the split nbr/cum "
                "tables (pool weights come from the cum rows) — build "
                "DeviceNeighborTable with fused=False")
        roots = batch["rows"][0]
        uniforms = batch.get("sample_uniforms")
        gen = None if uniforms is not None else batch_stream(
            batch, roots.device, self.stream_word)
        return sample_layerwise_rows(
            batch["nbr_table"], batch["cum_table"], roots, self.layer_sizes,
            generator=gen, uniforms=uniforms,
            alias_table=batch.get("alias_table"))

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        gen = batch.get("dropout_generator")
        if batch.get("adjs") is not None:
            return self.encoder(batch["layers"], batch["adjs"], gen)
        levels, adjs = self.sample_levels(batch)
        return self.encoder(gather_feature_rows(batch, levels), adjs, gen)


class DeviceSampledUnsupervisedSage(nn.Module):
    """Unsupervised GraphSAGE with its whole input path on the device:
    the fanout embedding, one positive per root (a one-neighbor draw)
    and num_negs negatives per root from the node sampler
    (parallel/device_walk.py), scored against one shared context table
    ctx_emb [num_rows + 1, dim]. Pairs whose positive is the pad row
    (roots without neighbors) are masked out of the loss and the MRR.

    The batch holds rows [roots int32], sample_seed, and the tables
    (the neighbor tables in any of the three layouts, feature_table,
    optional feature_scale, neg_rows, neg_cum). The draws follow the
    layout as DeviceSampledGraphSage's do. One stream, seeded from (29,
    sample_seed), feeds in order the fanout draw, the positives and the
    negatives; replayed uniforms replace any of them:
    batch["sample_uniforms"] (one tensor per hop), batch["pos_uniforms"]
    [B, 1] ([2, B, 1] for the alias draw) and batch["neg_uniforms"] [B,
    num_negs]. With the mean aggregator the deepest hop goes through
    ops.gather_mean (encode_fanout), one launch per forward on CUDA.
    Row-sharded tables cannot be built yet (DeviceNeighborTable refuses
    them)."""

    stream_word = 29

    def __init__(self, num_rows: int, in_dim: int, dim: int = 32,
                 fanouts: Sequence[int] = (10, 10),
                 aggregator: str = "mean", num_negs: int = 5,
                 uniform_sampling: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
        roots = batch["rows"][0]
        replays = [batch.get(k) for k in
                   ("sample_uniforms", "pos_uniforms", "neg_uniforms")]
        gen = None if all(r is not None for r in replays) else \
            batch_stream(batch, roots.device, self.stream_word)
        rows = sample_layers(batch, roots, self.fanouts, gen, replays[0],
                             self.uniform_sampling)
        pos = sample_one_hop(batch, roots, 1, gen, replays[1],
                             self.uniform_sampling)
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
