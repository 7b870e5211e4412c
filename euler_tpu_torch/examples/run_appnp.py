"""APPNP on a citation stand-in (counterpart of
examples/appnp/run_appnp.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_appnp [--dataset cora] \\
        [--seed 0] [--device cpu]

BaseGNNNet('appnp') over FullBatchDataFlow in a NodeEstimator
(common.run_citation); prints the result dict of fit_citation
(test_metric is the test split's micro-F1 at the best-val weights).
--seed seeds the engine's root draws, the init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = citation_argparser().parse_args(argv)
    return run_citation("appnp", args, conv_kwargs={'k_hop': 10, 'alpha': 0.1})


if __name__ == "__main__":
    main()
