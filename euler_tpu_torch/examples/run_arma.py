"""ARMA on a citation stand-in (counterpart of
examples/arma/run_arma.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_arma [--dataset cora] \\
        [--seed 0] [--device cpu]

BaseGNNNet('arma') over FullBatchDataFlow in a NodeEstimator
(common.run_citation); prints the result dict of fit_citation
(test_metric is the test split's micro-F1 at the best-val weights).
--seed seeds the engine's root draws, the init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = citation_argparser(dropout=0.5, weight_decay=0.005,
                              max_steps=300).parse_args(argv)
    return run_citation("arma", args,
                        conv_kwargs={'num_stacks': 2, 'arma_layers': 1})


if __name__ == "__main__":
    main()
