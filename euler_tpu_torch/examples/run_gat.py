"""GAT on a citation stand-in (counterpart of
examples/gat/run_gat.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_gat [--dataset cora] \\
        [--seed 0] [--device cpu]

BaseGNNNet('gat', 8 heads) over FullBatchDataFlow in a NodeEstimator
(common.run_citation); prints the result dict of fit_citation
(test_metric is the test split's micro-F1 at the best-val weights).
--seed seeds the engine's root draws, the init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = citation_argparser(
        hidden_dim=16, dropout=0.6, weight_decay=0.005, learning_rate=0.005,
        max_steps=500).parse_args(argv)
    return run_citation("gat", args, conv_kwargs={'heads': 8})


if __name__ == "__main__":
    main()
