"""AdaptiveGCN on a citation stand-in (counterpart of
examples/adaptivegcn/run_adaptivegcn.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_adaptivegcn \\
        [--dataset cora] [--seed 0] [--device cpu]

BaseGNNNet('graph', GraphConv) over FullBatchDataFlow in a
NodeEstimator (common.run_citation); prints the result dict of
fit_citation. --dropout below 0 (the default) means 0.6 on cora and
0.5 elsewhere, as in the reference. --seed seeds the engine's root
draws, the init and the dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = citation_argparser(dropout=-1.0, weight_decay=0.005,
                              max_steps=300).parse_args(argv)
    if args.dropout < 0:
        args.dropout = 0.6 if args.dataset == "cora" else 0.5
    return run_citation("graph", args, conv_kwargs=None)


if __name__ == "__main__":
    main()
