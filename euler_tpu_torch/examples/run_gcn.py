"""GCN node classification (counterpart of examples/gcn/run_gcn.py, with
the same defaults).

    python -m euler_tpu_torch.examples.run_gcn [--dataset cora] \\
        [--conv gcn] [--run_mode train_and_evaluate] [--seed 0] \\
        [--device cpu]

BaseGNNNet(--conv) over FullBatchDataFlow in a NodeEstimator (Adam,
max_id of the dataset; common.run_citation); in train_and_evaluate
mode prints the result dict of fit_citation (test_metric is the test
split's micro-F1 at the best-val weights). --seed seeds the engine's
root draws and the init.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.common import citation_argparser, run_citation


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = citation_argparser(max_steps=300)
    ap.add_argument("--conv", default="gcn")
    args = ap.parse_args(argv)
    return run_citation(args.conv, args, dataset_max_id=True)


if __name__ == "__main__":
    main()
