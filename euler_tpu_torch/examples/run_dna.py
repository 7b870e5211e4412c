"""DNA, dynamic neighborhood aggregation over the layer history
(counterpart of examples/dna/run_dna.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_dna [--dataset cora] \\
        [--seed 0] [--device cpu]

DNAModel: proj (relu) over the dropped-out features, then num_layers
DNAConv layers ("dna_{i}"), each over the dropped-out stack of every
layer so far, [N, T, D]; the last layer's root rows are the embedding.
FullBatchDataFlow in a NodeEstimator (common.run_citation); prints the
result dict of fit_citation. --seed seeds the engine's root draws, the
init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.convolution import DNAConv
from euler_tpu_torch.examples.common import citation_argparser, run_citation
from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.ops import mp_ops as mp
from euler_tpu_torch.utils.layers import Dense, Dropout


class DNAModel(SuperviseModel):
    """The reference runner's DNAModel: input dropout, proj, relu, then
    the DNAConv stack over the growing history, dropout on the history
    before each layer (one Dropout, "drop")."""

    def __init__(self, num_classes: int, in_dim: int, dim: int,
                 num_layers: int, heads: int, dropout: float,
                 multilabel: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, multilabel, dim, generator=generator)
        self.drop = Dropout(dropout)
        self.proj = Dense(in_dim, dim, generator=generator)
        self.num_layers = int(num_layers)
        for i in range(self.num_layers):
            self.add_module(f"dna_{i}", DNAConv(dim, dim, heads=heads,
                                                generator=generator))

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        x, edge_index = batch["x"], batch["edge_index"]
        gen = batch.get("dropout_generator")
        n = x.shape[0]
        h = torch.relu(self.proj(self.drop(x, gen)))
        hist = h[:, None, :]
        for i in range(self.num_layers):
            h = getattr(self, f"dna_{i}")(self.drop(hist, gen), edge_index,
                                          n)
            hist = torch.cat([hist, h[:, None, :]], dim=1)
        root = batch.get("root_index")
        return h if root is None else mp.gather(h, root)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = citation_argparser(num_layers=3, max_steps=400, dropout=0.5,
                            weight_decay=0.005)
    ap.add_argument("--heads", type=int, default=1)
    args = ap.parse_args(argv)
    return run_citation("dna", args, model_fn=lambda data, gen: DNAModel(
        data.num_classes, data.feature_dim, args.hidden_dim,
        args.num_layers, args.heads, args.dropout,
        multilabel=data.multilabel, generator=gen))


if __name__ == "__main__":
    main()
