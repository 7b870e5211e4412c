"""Plain GeniePath (Liu et al., "GeniePath: Graph Neural Networks with
Adaptive Receptive Paths", AAAI 2019, arXiv:1802.00910) in Euler's form
(tf_euler's GenieEncoder), written from its equations; softmax
cross-entropy averaged over the batch, and Adam. It imports nothing of
the program.

Over a fanout of hops 0 .. L (x_l: hop l's int8 rows times their
bfloat16 scale, read in float32):
- every hop projected: h_l = P x_l + p;
- s_0 = F_0 h_0 + f_0;
- depth t = 0 .. L-1, hop l < L - t, S = [h_l ; the k neighbour rows of
  h_{l+1}] (the breadth function):
    a = softmax_j(q_t · tanh(K_t S_j + κ_t)),
    h'_l = tanh(W_{t,l} Σ_j a_j S_j + w_{t,l}),
  then s_{t+1} = F_{t+1} h'_0 + f_{t+1};
- the embedding is the last hidden state of an LSTM over (s_0 .. s_L)
  from a zero carry (the depth function): gates i, f, g, o, each an
  input kernel without bias plus a recurrent kernel with bias,
  c' = σ(f)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c');
- logits = O e + o.

Departures from the paper, as Euler has them:
- the attention's query is one global vector q_t a depth; the paper's
  score also holds a term W_s h_i of the centre node;
- the LSTM runs once over the stacked depth states (the paper's
  GeniePath-lazy), not as gates inside each layer;
- the projection P is shared by every hop.

The tables, the draw, the int8 storage, Adam and the precision switch
are common.py's. The model reads no neighbour mean; `step` returns the
plain-order bfloat16 mean of the deepest hop beside its results, for
the harness's comparison of the program's kernel, and trains without
it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from gnnbench.reference.common import (
    Adam, Precision, dequantize, neighbor_mean, neighbor_table,
    quantize_int8, stream, uniform_hop,
)

ENC = "encoder.enc"
LSTM = f"{ENC}.depth_lstm.OptimizedLSTMCell_0"
GATES = ("i", "f", "g", "o")


def check_config(cfg: dict) -> None:
    """Refuse a configuration whose stated model, storage, precision or
    optimizer this reference does not compute."""
    m = cfg["model"]
    stated = {"encoder": (m.get("encoder"), "genie"),
              "feature_values": (m.get("feature_values"), "int8"),
              "feature_scale": (m.get("feature_scale"), "bfloat16"),
              "precision": (cfg.get("precision"), "float32"),
              "optimizer": (cfg["optimizer"].get("name"), "adam")}
    for key, (value, known) in stated.items():
        if value != known:
            raise ValueError(f"{key} {value!r}: the reference computes "
                             f"{known!r} only")


class Reference:
    """One float32 GeniePath training step at a time, over a two-hop (or
    deeper) fanout drawn uniformly from each node's capped neighbour
    table. Every product is float32 with TF32 off, or TF32 for the
    control (common.Precision).

    fault: None, or one planted for the readings of the limits:
    "half_batch" (the loss over the first half of the roots) or
    "altered_picks" (every pick but the roots moved one on)."""

    seed_word = 17  # the supervised family's sampling stream

    def __init__(self, cfg: dict, graph, table_seed: int,
                 weights: Dict[str, torch.Tensor], device,
                 precision: str = "float32", fault: Optional[str] = None):
        check_config(cfg)
        m = cfg["model"]
        self.fanouts = [int(k) for k in m["fanouts"]]
        self.optimizer = cfg["optimizer"]
        self.device = device
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

    def picks(self, batch) -> List[torch.Tensor]:
        """[roots, hop 1, ..., hop L] rows of the batch's draw."""
        roots = batch["roots"].long()
        gen = stream(self.seed_word, batch["sample_seed"], roots.device)
        layers = [roots]
        for k in self.fanouts:
            layers.append(uniform_hop(self.table, layers[-1], k, gen))
        return layers

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p = self.params
        return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))

    def _breadth(self, t: int, hop: int, h: torch.Tensor,
                 nbr: torch.Tensor) -> torch.Tensor:
        """tanh(W_{t,hop} Σ_j a_j S_j + w) over S = [h ; nbr] [n, k+1, d]."""
        s = torch.cat([h[:, None, :], nbr], dim=1)
        att = f"{ENC}.att_{t}"
        score = torch.tanh(self._dense(f"{att}.key", s)) \
            @ self.params[f"{att}.query"]
        a = torch.softmax(score, dim=1)
        pooled = (a[:, :, None] * s).sum(1)
        return torch.tanh(self._dense(f"{ENC}.w_{t}_{hop}", pooled))

    def _lstm(self, states: List[torch.Tensor]) -> torch.Tensor:
        """The last hidden state of the LSTM over the depth states."""
        c = h = torch.zeros_like(states[0])
        for x in states:
            gate = {g: self._dense(f"{LSTM}.i{g}", x)
                    + self._dense(f"{LSTM}.h{g}", h) for g in GATES}
            c = torch.sigmoid(gate["f"]) * c \
                + torch.sigmoid(gate["i"]) * torch.tanh(gate["g"])
            h = torch.sigmoid(gate["o"]) * torch.tanh(c)
        return h

    def embed(self, rows: List[torch.Tensor]) -> torch.Tensor:
        hops = len(self.fanouts)
        hidden = [self._dense(f"{ENC}.proj",
                              dequantize(self.q[r], self.scale).float())
                  for r in rows]
        states = [self._dense(f"{ENC}.depth_fc_0", hidden[0])]
        for t in range(hops):
            hidden = [self._breadth(t, hop, hidden[hop],
                                    hidden[hop + 1].reshape(
                                        hidden[hop].shape[0],
                                        self.fanouts[hop], -1))
                      for hop in range(hops - t)]
            states.append(self._dense(f"{ENC}.depth_fc_{t + 1}", hidden[0]))
        return self._lstm(states)

    def loss(self, rows: List[torch.Tensor]) -> torch.Tensor:
        logits = self._dense("out", self.embed(rows))
        per_row = F.cross_entropy(logits, self.labels[rows[0]],
                                  reduction="none")
        if self.fault == "half_batch":
            per_row = per_row[: rows[0].shape[0] // 2]
        return per_row.mean()

    def deepest_mean(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """The bfloat16 plain-order mean over each row's deepest-hop
        neighbours (the harness compares the program's kernel to it)."""
        return neighbor_mean(self.q, rows[-1].reshape(-1, self.fanouts[-1]),
                             self.scale)

    def step(self, batch, means: Optional[torch.Tensor] = None):
        """One step: (loss, the gradients, the picks, the deepest mean of
        the picks); Adam updates the parameters. means (the program's
        deepest means) are not read: the model takes no mean."""
        with self.prec.active():
            rows = self.picks(batch)
            if self.fault == "altered_picks":
                rows = [rows[0]] + [torch.roll(x, 1) for x in rows[1:]]
            own = self.deepest_mean(rows)
            loss = self.loss(rows)
            grads = torch.autograd.grad(loss, list(self.params.values()))
        grads = dict(zip(self.params, grads))
        self.adam.update(self.params, grads)
        return float(loss.detach()), grads, rows, own
