"""GraphGCN graph classification on mutag (counterpart of
examples/graphgcn/run_graphgcn.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_graphgcn [--seed 0] [--device cpu]

GraphModel(conv "gcn", pool "sum") through graph_common.run_graph_model;
prints the result dict (eval_metric: the eval split's accuracy at the
best sweep's weights).

4 layers of width 64 for 1200 steps, and the sum readout (the
reference's graphgcn pools with 'add'), as the reference runner sets.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.graph_common import (
    graph_argparser, run_graph_model,
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = graph_argparser(num_layers=4, hidden_dim=64,
                           max_steps=1200).parse_args(argv)
    return run_graph_model("gcn", "sum", args)


if __name__ == "__main__":
    main()
