"""Node encoders (counterpart of euler_tpu/utils/encoders.py:31-358):
`ShallowEncoder` (:31-55); the fanout encoders `SageEncoder`,
`GCNEncoder`, `GenieEncoder`, `SparseSageEncoder` (:282-300), and the
activation-cache
pair `ScalableGCNEncoder` / `ScalableSageEncoder` with `_ema_update`
and `_ScalableCache`; the layerwise `LayerEncoder` (:255-279); and
LGCN's `LGCEncoder` (:342-358).

The fanout encoders that reduce the deepest hop with a plain mean (sage
with the mean aggregator, gcn) also take that hop as its neighbor mean
(`nbr_mean`, e.g. from ops.gather_mean), so its [n·k, D] layer need not
exist.

The scalable encoders keep one cache per non-input layer, a module
buffer "h" [max_id + 1, dim] (the reference's `cache` collection,
encoder/cache_{l}/h). In training the batch's rows are written and then
read back by the next layer in the same forward, and the gradient flows
through what was written, as it does through the reference's mutable
collection; see `_ScalableCache`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch.obs.device import mark
from euler_tpu_torch.parallel import collectives
from euler_tpu_torch.parallel.placement import row_shard
from euler_tpu_torch.ops.gather_mean import gather_mean
from euler_tpu_torch.utils.aggregators import get_aggregator
from euler_tpu_torch.utils.layers import (
    _TRUNC_STD, AttLayer, Dense, Dropout, Embedding, LSTMLayer,
    SparseEmbedding, bucketize_ids,
)


def _hop_neighbors(child: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Reshape hop h+1's flat layer to [n_h, k, D], deriving k from the
    shapes."""
    n = parent.shape[0]
    if child.shape[0] % n != 0:
        raise ValueError(f"layer of {child.shape[0]} rows is not a whole "
                         f"fanout of the {n}-row parent layer")
    return child.reshape(n, child.shape[0] // n, -1)


class SageEncoder(nn.Module):
    """GraphSAGE encoder over a sampled fanout.

    layers[h]: features of hop h, [B·Πk_{<h}, D]. Aggregates deepest
    first with fresh aggregator params per depth (submodules agg_{d}).
    The deepest hop L may be passed either as its gathered rows
    (layers has L+1 entries) or, with the 'mean' aggregator, as its
    neighbor mean `nbr_mean` [B·Πk_{<L}, D] (layers has L entries): at
    depth 0 hop L-1 reads hop L only through that mean, so the [n·k, D]
    deepest layer never has to exist.
    """

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 aggregator: str = "mean", concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanouts = tuple(int(k) for k in fanouts)
        self.aggregator = aggregator.lower()
        agg_cls = get_aggregator(aggregator)
        width = in_dim
        for depth in range(len(self.fanouts)):
            agg = agg_cls(width, dim, concat=concat, generator=generator)
            self.add_module(f"agg_{depth}", agg)
            width = agg.out_dim
        self.out_dim = width

    def forward(self, layers: Sequence[torch.Tensor],
                nbr_mean: Optional[torch.Tensor] = None) -> torch.Tensor:
        n_hops = len(self.fanouts)
        if nbr_mean is not None and self.aggregator != "mean":
            raise ValueError("a precomputed neighbor mean needs the 'mean' "
                             f"aggregator, not {self.aggregator!r}")
        want = n_hops if nbr_mean is not None else n_hops + 1
        if len(layers) != want:
            raise ValueError(f"need {want} feature layers for {n_hops} "
                             f"fanouts, got {len(layers)}")
        hidden = list(layers)
        for depth in range(n_hops):
            agg = getattr(self, f"agg_{depth}")
            next_hidden = []
            for hop in range(n_hops - depth):
                x = hidden[hop]
                if nbr_mean is not None and depth == 0 and hop == n_hops - 1:
                    next_hidden.append(agg(x, nbr_mean=nbr_mean))
                else:
                    next_hidden.append(
                        agg(x, _hop_neighbors(hidden[hop + 1], x)))
            hidden = next_hidden
        return hidden[0]


def _mean_with_self(x: torch.Tensor, nbr: Optional[torch.Tensor] = None,
                    nbr_mean: Optional[torch.Tensor] = None,
                    count: int = 0) -> torch.Tensor:
    """mean over concat([x[:, None], nbr], 1) [n, k+1, D], from nbr
    [n, k, D] or from its mean over k (then (x + k·mean) / (k + 1) in
    float32), in x's dtype as the reference's jnp mean returns it."""
    if nbr_mean is None:
        return torch.cat([x[:, None, :], nbr], dim=1).mean(1)
    m = (x.to(torch.float32) + count * nbr_mean.to(torch.float32)) \
        / (count + 1)
    return m.to(x.dtype)


class GCNEncoder(nn.Module):
    """GCN-style encoder over a fanout (counterpart of
    euler_tpu/utils/encoders.py:GCNEncoder): per depth one shared
    transform w_{depth} (no bias) of the mean of each node with its
    neighbors, relu except at the last depth. layers as SageEncoder's;
    the deepest hop may come as its neighbor mean `nbr_mean` with its
    neighbor count `nbr_count` (then layers has L entries)."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanouts = tuple(int(k) for k in fanouts)
        width = in_dim
        for depth in range(len(self.fanouts)):
            self.add_module(f"w_{depth}", Dense(width, dim, use_bias=False,
                                                generator=generator))
            width = dim
        self.out_dim = dim

    def forward(self, layers: Sequence[torch.Tensor],
                nbr_mean: Optional[torch.Tensor] = None,
                nbr_count: int = 0) -> torch.Tensor:
        n_hops = len(self.fanouts)
        want = n_hops if nbr_mean is not None else n_hops + 1
        if len(layers) != want:
            raise ValueError(f"need {want} feature layers for {n_hops} "
                             f"fanouts, got {len(layers)}")
        hidden = list(layers)
        for depth in range(n_hops):
            w = getattr(self, f"w_{depth}")
            last = depth == n_hops - 1
            next_hidden = []
            for hop in range(n_hops - depth):
                x = hidden[hop]
                if nbr_mean is not None and depth == 0 \
                        and hop == n_hops - 1:
                    m = _mean_with_self(x, nbr_mean=nbr_mean,
                                        count=nbr_count)
                else:
                    m = _mean_with_self(x, _hop_neighbors(hidden[hop + 1], x))
                h = w(m)
                next_hidden.append(h if last else torch.relu(h))
            hidden = next_hidden
        return hidden[0]


class GenieEncoder(nn.Module):
    """GeniePath over a fanout (counterpart of
    euler_tpu/utils/encoders.py:GenieEncoder): every layer projected to
    dim ("proj"); per depth an attention pool (att_{depth}) of each
    node with its neighbors, then tanh(w_{depth}_{hop}); the root's
    representation after each depth through depth_fc_{d}; an LSTM over
    that depth sequence (depth_lstm), whose last step is the output.

    Inside a training update it marks the forward's phases
    (obs/device.py): `gather` on entry (the layers are read), `breadth`
    after the last depth_fc, `depth` after the LSTM."""

    def __init__(self, in_dim: int, dim: int, fanouts: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fanouts = tuple(int(k) for k in fanouts)
        n_hops = len(self.fanouts)
        self.proj = Dense(in_dim, dim, generator=generator)
        self.add_module("depth_fc_0", Dense(dim, dim, generator=generator))
        for depth in range(n_hops):
            self.add_module(f"att_{depth}",
                            AttLayer(dim, dim, generator=generator))
            for hop in range(n_hops - depth):
                self.add_module(f"w_{depth}_{hop}",
                                Dense(dim, dim, generator=generator))
            self.add_module(f"depth_fc_{depth + 1}",
                            Dense(dim, dim, generator=generator))
        self.depth_lstm = LSTMLayer(dim, dim, generator=generator)
        self.out_dim = dim

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        n_hops = len(self.fanouts)
        if len(layers) != n_hops + 1:
            raise ValueError(f"need {n_hops + 1} feature layers for "
                             f"{n_hops} fanouts, got {len(layers)}")
        mark("gather")
        hidden = [self.proj(h) for h in layers]
        h_t = [getattr(self, "depth_fc_0")(hidden[0])]
        for depth in range(n_hops):
            att = getattr(self, f"att_{depth}")
            next_hidden = []
            for hop in range(n_hops - depth):
                x = hidden[hop]
                nbr = _hop_neighbors(hidden[hop + 1], x)
                pooled = att(torch.cat([x[:, None, :], nbr], dim=1))
                next_hidden.append(torch.tanh(
                    getattr(self, f"w_{depth}_{hop}")(pooled)))
            hidden = next_hidden
            h_t.append(getattr(self, f"depth_fc_{depth + 1}")(hidden[0]))
        mark("breadth")
        # the reference follows the paper: the LSTM's last step
        out = self.depth_lstm(torch.stack(h_t, dim=1))[:, -1, :]
        mark("depth")
        return out


def _ema_update(old: torch.Tensor, fresh: torch.Tensor,
                decay: float) -> torch.Tensor:
    """Bias-corrected cache write (counterpart of
    euler_tpu/utils/encoders.py:_ema_update): a row never written (all
    zero) takes the fresh activation at full scale, a visited row
    decay·old + (1 - decay)·fresh."""
    seen = (old != 0).any(-1, keepdim=True)
    return torch.where(seen, decay * old + (1 - decay) * fresh, fresh)


class _WrittenRowsMean(torch.autograd.Function):
    """The neighbor mean over a cache this forward wrote: the value is
    the kernel's mean over the cache as it now stands; the gradient goes
    to the written values, as the reference's read of its mutated
    collection sends it (each neighbor slot that reads a written row
    adds its share, g / k, to that row's winning write)."""

    @staticmethod
    def forward(ctx, written, mean, hit, cache_dtype):
        ctx.save_for_backward(hit)
        ctx.rows, ctx.cache_dtype = written.shape[0], cache_dtype
        return mean.clone()

    @staticmethod
    def backward(ctx, g):
        hit, = ctx.saved_tensors
        b = ctx.rows
        n, k = hit.shape
        # a slot that reads no written row adds to a discarded row of its
        # own root (b + i), so no one row collects most of the slots
        own = torch.arange(b, b + n, device=hit.device)[:, None]
        idx = torch.where(hit < 0, own, hit).reshape(-1)
        src = (g / k)[:, None, :].expand(-1, k, -1).reshape(-1, g.shape[1])
        # the embedding lookup's backward: deterministic on CUDA (it
        # sorts the indices and sums each row's run in order)
        acc = torch.ops.aten.embedding_dense_backward(
            src, idx, b + n, -1, False)[:b]
        if ctx.cache_dtype != torch.float32:
            # the reference's cotangent crosses the cache's dtype
            acc = acc.to(ctx.cache_dtype).to(torch.float32)
        return acc, None, None, None


class _ScalableCache(nn.Module):
    """Per-node activation cache (counterpart of
    euler_tpu/utils/encoders.py:_ScalableCache): buffer "h"
    [max_id + 1, dim] in float32 or bfloat16, read as float32 rows at
    bucketize_ids(ids, max_id + 1).

    `write(ids, vals)` stores rows in place. Roots repeat within a batch:
    the last occurrence of a row wins, as XLA's scatter keeps it on the
    CPU, and every duplicate writes the winner's value, so the in-place
    write is deterministic. The rows' previous values are kept
    (`staged`) until the estimator settles the step: a step the
    nonfinite guard skips puts them back (`settle`), as the reference
    keeps its old collection. The next `neighbor_mean` of the same
    forward reads the written rows through `_WrittenRowsMean`.

    Inside collectives.data_parallel a write is the global batch's (the
    data axis's ids and values gathered in rank order; the values'
    gradient goes back to the ranks that computed them), so every
    replica writes the same rows. models.graphsage.shard_act_cache
    row-shards "h" over a mesh's model axis (`mesh`): reads go through
    make_table_gather and each rank writes the rows it owns."""

    def __init__(self, max_id: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mesh = None
        self.num_rows = int(max_id) + 1
        self.register_buffer("h", torch.zeros((self.num_rows, dim),
                                              dtype=dtype))
        # row → batch position of its winning write, -1 elsewhere
        self.register_buffer("_hit", torch.full((self.num_rows,), -1,
                                                dtype=torch.int64),
                             persistent=False)
        self.staged = None
        self._written = None

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        return bucketize_ids(ids, self.num_rows)

    def read(self, ids: torch.Tensor) -> torch.Tensor:
        if row_shard(self.h) is not None:
            from euler_tpu_torch.parallel.device_sampler import (
                make_table_gather,
            )

            return make_table_gather(self.mesh)(
                self.h, self.rows(ids)).to(torch.float32)
        return self.h[self.rows(ids).long()].to(torch.float32)

    def write(self, ids: torch.Tensor, vals: torch.Tensor) -> None:
        ids = collectives.global_rows(ids)
        vals = collectives.global_rows_summed(vals)
        rows = self.rows(ids).long()
        b = rows.shape[0]
        srt, perm = torch.sort(rows, stable=True)
        pos = torch.arange(b, device=rows.device)
        is_last = torch.ones_like(srt, dtype=torch.bool)
        is_last[:-1] = srt[1:] != srt[:-1]
        # for each sorted position, the last position of its run
        last = torch.where(is_last, pos, b).flip(0).cummin(0).values.flip(0)
        winner = torch.empty_like(perm).scatter_(0, perm, perm[last])
        won = vals[winner]
        info = row_shard(self.h)
        mine, put = rows, won.detach()
        if info is not None:
            # the rows this rank's shard owns
            local = rows - info.lo
            ok = (local >= 0) & (local < info.rows)
            mine, put = local[ok], put[ok]
        self.staged = (mine, self.h[mine])
        self.h.index_put_((mine,), put.to(self.h.dtype))
        self._written = (rows, won, winner)

    def settle(self, skip: Optional[torch.Tensor]) -> None:
        """End of a training step: skip (a device scalar, 1.0 when the
        nonfinite guard skipped the step) restores the staged rows."""
        if self.staged is not None and skip is not None:
            rows, old = self.staged
            self.h.index_put_((rows,), torch.where(
                skip > 0, old, self.h[rows]))
        self.staged = self._written = None

    def neighbor_mean(self, nbr_ids: torch.Tensor,
                      neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        """[B, K] neighbor ids → [B, dim] float32 mean of their rows:
        one neighbor_mean(table, rows, scale, out_dtype) call (the
        gather_mean kernel on CUDA), a bfloat16 cache read as float32."""
        rows = self.rows(nbr_ids).contiguous()
        out_dtype = torch.float32 if self.h.dtype == torch.bfloat16 \
            else None
        m = neighbor_mean(self.h, rows, None, out_dtype=out_dtype)
        if self._written is None:
            return m
        w_rows, won, winner = self._written
        self._written = None
        self._hit.index_put_((w_rows,), winner)
        hit = self._hit[rows.long()]
        self._hit.index_fill_(0, w_rows, -1)
        return _WrittenRowsMean.apply(won, m, hit, self.h.dtype)


class _ScalableEncoder(nn.Module):
    """The layers shared by the two scalable encoders: 1-hop input (ids
    [B], x [B, D], the neighbors' ids [B, K] and their feature mean
    [B, D]); layer l >= 1 reads its neighbors from cache_{l}; each layer
    but the last stores its output for the batch's ids into the next
    cache (write=True) after the bias-corrected EMA."""

    def __init__(self, in_dim: int, dim: int, num_layers: int, max_id: int,
                 store_decay: float = 0.9,
                 cache_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = int(num_layers)
        self.store_decay = float(store_decay)
        for layer in range(self.num_layers):
            self.add_module(f"w_{layer}", self._layer(
                in_dim if layer == 0 else dim, dim, generator))
        for layer in range(1, self.num_layers):
            self.add_module(f"cache_{layer}",
                            _ScalableCache(max_id, dim, dtype=cache_dtype))
        self.out_dim = dim

    def caches(self):
        return [getattr(self, f"cache_{layer}")
                for layer in range(1, self.num_layers)]

    def forward(self, ids: torch.Tensor, x: torch.Tensor,
                nbr_ids: torch.Tensor, nbr_x_mean: torch.Tensor,
                write: bool = False,
                neighbor_mean: Callable = gather_mean) -> torch.Tensor:
        k = nbr_ids.shape[1]
        h_self = x
        for layer in range(self.num_layers):
            if layer == 0:
                m = nbr_x_mean
            else:
                m = getattr(self, f"cache_{layer}").neighbor_mean(
                    nbr_ids, neighbor_mean)
            h_new = self._combine(getattr(self, f"w_{layer}"), h_self, m, k)
            if layer < self.num_layers - 1:
                h_new = torch.relu(h_new)
                store = getattr(self, f"cache_{layer + 1}")
                if write:
                    store.write(ids, _ema_update(store.read(ids), h_new,
                                                 self.store_decay))
            h_self = h_new
        return h_self


class ScalableGCNEncoder(_ScalableEncoder):
    """Scalable GCN (counterpart of
    euler_tpu/utils/encoders.py:ScalableGCNEncoder): layer l is
    w_{l}(mean of self and neighbors), no bias."""

    @staticmethod
    def _layer(in_dim, dim, generator):
        return Dense(in_dim, dim, use_bias=False, generator=generator)

    @staticmethod
    def _combine(w, h_self, m, k):
        return w(_mean_with_self(h_self, nbr_mean=m, count=k))


class ScalableSageEncoder(_ScalableEncoder):
    """Scalable GraphSAGE (counterpart of
    euler_tpu/utils/encoders.py:ScalableSageEncoder): layer l is
    w_{l}(concat(self, neighbor mean))."""

    @staticmethod
    def _layer(in_dim, dim, generator):
        return Dense(2 * in_dim, dim, generator=generator)

    @staticmethod
    def _combine(w, h_self, m, k):
        return w(torch.cat([h_self, m.to(h_self.dtype)], dim=-1))


class LayerEncoder(nn.Module):
    """The layerwise (FastGCN/LADIES) encoder: h_{l} = Â_l · W_l(h_{l+1})
    from the deepest pool up, relu between layers, no bias (Dense
    `w_{i}`). layers[l]: the level-l features [m_l, D], layers[-1] the
    deepest pool, layers[0] the batch nodes; adjs[l]: the dense
    row-normalized [m_l, m_{l+1}] adjacency between levels (built by
    LayerwiseDataFlow or sample_layerwise_rows). dropout: the input
    dropout before each layer (the standard FastGCN setup), in training
    mode only, drawn from `generator`."""

    def __init__(self, in_dim: int, dim: int, num_layers: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = int(num_layers)
        self.drop = Dropout(dropout)
        self.out_dim = int(dim)
        for i in range(self.num_layers):
            width = in_dim if i == self.num_layers - 1 else dim
            self.add_module(f"w_{i}", Dense(width, dim, use_bias=False,
                                            generator=generator))

    def forward(self, layers: Sequence[torch.Tensor],
                adjs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if len(adjs) != self.num_layers or len(layers) != len(adjs) + 1:
            raise ValueError(f"need {self.num_layers} adjacencies and "
                             f"{self.num_layers + 1} levels, got "
                             f"{len(adjs)} and {len(layers)}")
        h = layers[-1]
        for i in range(self.num_layers - 1, -1, -1):
            h = self.drop(h, generator)
            h = adjs[i] @ getattr(self, f"w_{i}")(h)
            if i > 0:
                h = torch.relu(h)
        return h


class LGCEncoder(nn.Module):
    """The LGCN encoder: for each feature channel the k largest values
    among a node's neighbors, in descending order after the node's own
    value, then a VALID 1-D convolution of width k + 1 over that
    sequence of k + 1 positions (torch.nn.Conv1d "conv", weight [dim, D,
    k + 1]; flax's Conv kernel is [k + 1, D, dim], and convert.py maps
    the two). x [B, D], nbr [B, K, D] with K >= k → [B, dim]. Fresh init
    is flax Conv's: lecun_normal over fan_in = (k + 1)·D, zero bias."""

    def __init__(self, in_dim: int, dim: int, k: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k, self.out_dim = int(k), int(dim)
        self.conv = nn.Conv1d(in_dim, dim, self.k + 1)
        std = math.sqrt(1.0 / (in_dim * (self.k + 1))) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.conv.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            self.conv.bias.zero_()

    def forward(self, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        # the top k per channel: values in descending order, as
        # lax.top_k's, so the order among ties does not matter
        topk = torch.topk(nbr.transpose(1, 2), self.k, dim=-1).values
        seq = torch.cat([x[:, :, None], topk], dim=-1)      # [B, D, k+1]
        # a VALID convolution as wide as its input has one output
        # position, so it is one matrix product: a GEMM, the same bits
        # every run on the card, where cuDNN's convolution backward may
        # pick an algorithm that adds with atomics
        w = self.conv.weight
        return F.linear(seq.flatten(1), w.flatten(1), self.conv.bias)


class ShallowEncoder(nn.Module):
    """Id embedding and/or dense features (counterpart of
    euler_tpu/utils/encoders.py:ShallowEncoder): id_emb, an Embedding
    [max_id + 1, dim] when max_id > 0, and feat, a Dense in_dim → dim
    over the features when use_feature (and the call passes them),
    combined by "concat" or "add". out_dim is the concatenated width."""

    def __init__(self, dim: int, max_id: int = 0, use_feature: bool = True,
                 combiner: str = "concat", in_dim: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("concat", "add"):
            raise ValueError(f"combiner must be concat or add, got "
                             f"{combiner!r}")
        self.combiner = combiner
        self.use_feature = bool(use_feature) and in_dim > 0
        if max_id > 0:
            self.id_emb = Embedding(max_id + 1, dim, generator=generator)
        if self.use_feature:
            self.feat = Dense(in_dim, dim, generator=generator)
        if max_id <= 0 and not self.use_feature:
            raise ValueError("ShallowEncoder has neither id embedding nor "
                             "features")
        parts = int(max_id > 0) + int(self.use_feature)
        self.out_dim = dim * parts if combiner == "concat" else dim

    def forward(self, ids: torch.Tensor,
                feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = []
        if hasattr(self, "id_emb"):
            parts.append(self.id_emb(ids))
        if self.use_feature and feats is not None:
            parts.append(self.feat(feats))
        if not parts:
            raise ValueError("ShallowEncoder has neither id embedding nor "
                             "features")
        if len(parts) == 1:
            return parts[0]
        if self.combiner == "add":
            return sum(parts)
        return torch.cat(parts, dim=-1)


class SparseSageEncoder(nn.Module):
    """SAGE over sparse-id features (counterpart of
    euler_tpu/utils/encoders.py:SparseSageEncoder): each hop's padded
    ids [n_h, L] through one SparseEmbedding ("sp_emb", mean combiner)
    into a SageEncoder ("sage") of input width dim."""

    def __init__(self, dim: int, fanouts: Sequence[int],
                 num_embeddings: int, aggregator: str = "mean",
                 concat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sp_emb = SparseEmbedding(num_embeddings, dim,
                                      generator=generator)
        self.sage = SageEncoder(dim, dim, fanouts, aggregator, concat,
                                generator=generator)
        self.out_dim = self.sage.out_dim

    def forward(self, sparse_layers: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.sage([self.sp_emb(s) for s in sparse_layers])
