"""GIN with the Set2Set readout graph classification on mutag (counterpart of
examples/set2set/run_set2set.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_set2set [--seed 0] [--device cpu]

GraphModel(conv "gin", pool "set2set") through graph_common.run_graph_model;
prints the result dict (eval_metric: the eval split's accuracy at the
best sweep's weights).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples.graph_common import (
    graph_argparser, run_graph_model,
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = graph_argparser().parse_args(argv)
    return run_graph_model("gin", "set2set", args)


if __name__ == "__main__":
    main()
