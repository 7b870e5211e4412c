"""Plain pieces the references share: the neighbor table rebuilt from the
CSR, the int8 feature table, the uniform neighbor draw, the neighbor
mean, Adam, and SageReference, the mean-aggregator GraphSAGE step both
families train. Plain PyTorch; nothing here imports the program.

Where the reference has to meet the program bit for bit (the table's
slots, the draws' columns, the stored feature bytes) the arithmetic is a
frozen copy of the program's, and the docstring names the original.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

_M64 = (1 << 64) - 1


def seed_words(*words: int) -> int:
    """A 63-bit seed hashed from words (numpy's SeedSequence).

    Frozen copy of euler_tpu_torch/platform.py:34-43 (seed_words)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def _signed(c: int) -> int:
    c &= _M64
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def edge_uniforms(seed: int, rows: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Stateless per-edge float64 uniforms in [0, 1): a splitmix64
    finalizer over (seed, row, position in the row), in wrapping int64.

    Frozen copy of euler_tpu_torch/parallel/device_sampler.py:70-84
    (_edge_uniforms)."""
    x = (rows.long() << 32) ^ pos.long()
    x = x ^ _signed((seed & _M64) * 0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _signed(0x94D049BB133111EB)
    x = x ^ _lsr(x, 31)
    return _lsr(x, 11).double() * (2.0 ** -53)


def neighbor_table(offsets: torch.Tensor, neighbors: torch.Tensor,
                   cap: int, seed: int) -> torch.Tensor:
    """[N+1, cap] int64 neighbor rows, pad N in empty slots and in row N.
    A row of degree <= cap holds its neighbors in CSR order; a larger
    one keeps the cap edges of largest key u^(1/w) (unit weights: w = 1),
    largest first, equal keys in CSR order: the weighted choice without
    replacement that device_sampler.py:87-152 (_fill_table_rows) makes."""
    n = offsets.numel() - 1
    dev = neighbors.device
    deg = offsets[1:] - offsets[:-1]
    row = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    pos = torch.arange(neighbors.numel(), device=dev) - offsets[row]
    key = torch.exp(torch.log(edge_uniforms(seed, row, pos)
                              .clamp_min(1e-300)) / 1.0)
    by_key = torch.argsort(-key, stable=True)
    del key
    order = by_key[torch.argsort(row[by_key], stable=True)]
    del by_key
    rank = torch.empty_like(pos)
    rank[order] = torch.arange(order.numel(), device=dev) \
        - offsets[row[order]]
    del order
    slot = torch.where(deg[row] > cap, rank, pos)
    keep = slot < cap
    table = torch.full((n + 1, cap), n, dtype=torch.int64, device=dev)
    table[row[keep], slot[keep]] = neighbors[keep].long()
    return table


def quantize_int8(features: torch.Tensor):
    """Per-column symmetric int8: scale = colmax|x| / 127 (1 for an
    all-zero column), q = clip(rint(x / scale), -127, 127). Returns (q
    int8, scale float32).

    Frozen copy of euler_tpu_torch/parallel/feature_store.py:22-32
    (quantize_int8), in torch. The divisor is a tensor: on a card torch
    divides by a scalar through its reciprocal, which rounds a few
    scales one float32 ulp off numpy's quotient and moves the rounding
    of their columns' values."""
    x = features.to(torch.float32)
    amax = x.abs().amax(0)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q_rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 rows into the scale's dtype: each value times its column's
    scale, rounded once to that dtype."""
    return (q_rows.to(torch.float32) * scale.to(torch.float32)) \
        .to(scale.dtype)


def neighbor_mean(q: torch.Tensor, rows: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The mean over k of the int8 rows q[rows [n, k]], times the scale,
    in float32, rounded once to the scale's dtype: the plain order. A
    kernel may sum and scale in another order and round one ulp apart
    from this on a few outputs; the check's numbers are chosen so that
    such flips read as sound (PERF.md, the check)."""
    mean = q[rows].to(torch.float32).mean(1)
    return (mean * scale.to(torch.float32)).to(scale.dtype)


def uniform_hop(table: torch.Tensor, rows: torch.Tensor, count: int,
                gen: torch.Generator) -> torch.Tensor:
    """count neighbors a row, each uniform over the row's filled slots:
    column min(floor(u·deg), deg - 1) for float32 u; a row with no
    neighbor gives the pad. [n] → [n·count].

    The arithmetic of device_sampler.py:806-819 (sample_hop's uniform
    draw), on uniforms drawn as the program draws them."""
    pad = table.shape[0] - 1
    nbr = table[rows.long()]
    deg = (nbr != pad).sum(-1).to(torch.float32)
    u = torch.rand((rows.shape[0], count), generator=gen,
                   device=rows.device, dtype=torch.float32)
    col = torch.minimum((u * deg[:, None]).to(torch.int32),
                        (deg[:, None].to(torch.int32) - 1).clamp_min(0))
    return torch.gather(nbr, 1, col.long()).reshape(-1)


def stream(seed_word: int, sample_seed: int,
           device) -> torch.Generator:
    """A batch's sampling generator: seeded with
    seed_words(seed_word, sample_seed mod 2^32), as the program seeds
    the batch's stream (models/graphsage.py:181-197)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_words(seed_word, int(sample_seed) & 0xFFFFFFFF))
    return g


class Adam:
    """Adam (b1, b2, eps; no weight decay), one update at a time over a
    dict of float32 tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            step = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            p.sub_(self.lr * step)


class Precision:
    """How the reference computes its products: "float32" (TF32 off), or
    "tf32", the control's, one precision below: the card's TF32 switch,
    which a CPU does not have."""

    def __init__(self, name: str, device):
        if name not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        if name == "tf32" and torch.device(device).type != "cuda":
            raise ValueError("TF32 is a CUDA card's: the control runs there")
        self.name = name

    @contextlib.contextmanager
    def active(self):
        """TF32 on the card's matrix units while the control computes."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = old


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated storage, aggregator or
    precision this reference does not compute: such a cell would be
    checked against another model than it states."""
    m = cfg["model"]
    stated = {"aggregator": (m.get("aggregator"), "mean"),
              "feature_values": (m.get("feature_values"), "int8"),
              "feature_scale": (m.get("feature_scale"), "bfloat16"),
              "precision": (cfg.get("precision"), "float32"),
              "optimizer": (cfg["optimizer"].get("name"), "adam")}
    for key, (value, known) in stated.items():
        if value != known:
            raise ValueError(f"{key} {value!r}: the reference computes "
                             f"{known!r} only")


class SageReference:
    """One float32 training step at a time of a mean-aggregator
    GraphSAGE over a two-hop fanout drawn uniformly from each node's
    capped neighbor table, on int8 features with a bfloat16 per-column
    scale, and Adam over every parameter. The configuration's storage
    types hold: a feature row is read as bfloat16 (int8 times its scale),
    a mean of bfloat16 rows is bfloat16; every product is float32 with
    TF32 off (Precision "float32"), or TF32 for the control ("tf32").

    It rebuilds the neighbor and int8 tables from the benchmark's CSR and
    float features and starts from the benchmark's weights: nothing the
    program made. A family gives `enc` (the encoder's parameter prefix),
    `seed_word` (its sampling stream), `picks` and `loss`.

    fault: None, or one planted for the readings of the limits:
    "half_batch" (the loss over the first half of the rows) or
    "altered_picks" (every pick but the roots moved one on)."""

    enc = ""
    seed_word = 0

    def __init__(self, cfg: dict, graph, table_seed: int,
                 weights: Dict[str, torch.Tensor], device,
                 precision: str = "float32", fault: Optional[str] = None):
        check_config(cfg)
        m = cfg["model"]
        self.fanouts = [int(k) for k in m["fanouts"]]
        self.concat = bool(m["concat"])
        self.optimizer = cfg["optimizer"]
        self.device = device
        self.n = graph.num_nodes
        self.table = neighbor_table(graph.offsets, graph.neighbors,
                                    int(m["neighbor_cap"]), table_seed)
        feats = graph.features
        self.q, scale = quantize_int8(
            torch.cat([feats, feats.new_zeros(1, feats.shape[1])]))
        self.scale = scale.to(torch.bfloat16)
        self.labels = graph.labels
        self.start(weights, precision, fault)

    def start(self, weights: Dict[str, torch.Tensor],
              precision: str = "float32", fault: Optional[str] = None):
        """Start training again from `weights` with a fresh Adam, in
        `precision`, with `fault` planted; the tables stay."""
        self.prec = Precision(precision, self.device)
        self.fault = fault
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}
        a = self.optimizer
        self.adam = Adam(self.params, float(a["learning_rate"]),
                         float(a["b1"]), float(a["b2"]), float(a["eps"]))

    def fanout(self, roots: torch.Tensor, gen) -> List[torch.Tensor]:
        """[roots, hop 1, hop 2]: each hop drawn from the batch's stream."""
        layers = [roots]
        for k in self.fanouts:
            layers.append(uniform_hop(self.table, layers[-1], k, gen))
        return layers

    def _agg(self, x, nbr_mean, name):
        """relu(W_self x) beside (concat) or plus relu(W_nbr mean)."""
        p = self.params
        h = [torch.relu(F.linear(x.to(torch.float32),
                                 p[f"{name}.{part}.weight"],
                                 p[f"{name}.{part}.bias"]))
             for part, x in (("self", x), ("nbr", nbr_mean))]
        return torch.cat(h, dim=-1) if self.concat else h[0] + h[1]

    def deepest_mean(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """The bfloat16 mean over each hop-1 row's hop-2 neighbors."""
        return neighbor_mean(self.q, rows[2].reshape(-1, self.fanouts[1]),
                             self.scale)

    def embed(self, r0, r1, m2) -> torch.Tensor:
        """The encoder over [roots, hop 1] and hop 2's mean m2: depth 0
        on hops 0 and 1, depth 1 on the roots."""
        b, k1 = r0.shape[0], self.fanouts[0]
        x0 = dequantize(self.q[r0], self.scale)
        x1 = dequantize(self.q[r1], self.scale)
        a0, a1 = f"{self.enc}.agg_0", f"{self.enc}.agg_1"
        h0 = self._agg(x0, x1.reshape(b, k1, -1).mean(1), a0)
        h1 = self._agg(x1, m2, a0)
        return self._agg(h0, h1.reshape(b, k1, -1).mean(1), a1)

    def picks(self, batch) -> List[torch.Tensor]:
        raise NotImplementedError

    def loss(self, rows: List[torch.Tensor],
             m2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, batch, means: Optional[torch.Tensor] = None):
        """One step: (loss, the gradients, the picks, the deepest mean
        of the picks); Adam updates the parameters. means: hop 2's means
        to train on in place of the reference's own (the program's,
        once held to the reference's by themselves)."""
        with self.prec.active():
            rows = self.picks(batch)
            if self.fault == "altered_picks":
                rows = [rows[0]] + [torch.roll(x, 1) for x in rows[1:]]
            own = self.deepest_mean(rows)
            loss = self.loss(rows, own if means is None else means)
            grads = torch.autograd.grad(loss, list(self.params.values()))
        grads = dict(zip(self.params, grads))
        self.adam.update(self.params, grads)
        return float(loss.detach()), grads, rows, own
