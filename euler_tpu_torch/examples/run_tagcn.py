"""TAGCN on a citation stand-in (counterpart of
examples/tagcn/run_tagcn.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_tagcn [--dataset cora] \\
        [--seed 0] [--device cpu]

BaseGNNNet('tag', k_hop 3) over FullBatchDataFlow in a NodeEstimator
(common.run_citation); prints the result dict of fit_citation.
--learning_rate 0 and --max_steps 0 (the defaults) mean 0.01 and 200 on
citeseer, 0.005 and 500 elsewhere, as in the reference. --seed seeds
the engine's root draws, the init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = citation_argparser(learning_rate=0.0,
                              max_steps=0).parse_args(argv)
    if not args.learning_rate:
        args.learning_rate = 0.01 if args.dataset == "citeseer" else 0.005
    if not args.max_steps:
        args.max_steps = 200 if args.dataset == "citeseer" else 500
    return run_citation("tag", args, conv_kwargs={'k_hop': 3})


if __name__ == "__main__":
    main()
