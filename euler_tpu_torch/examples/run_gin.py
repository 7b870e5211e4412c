"""GIN graph classification on mutag (counterpart of
examples/gin/run_gin.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_gin [--seed 0] [--device cpu]

GraphModel(conv "gin", pool "sum") through graph_common.run_graph_model;
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
    return run_graph_model("gin", "sum", args)


if __name__ == "__main__":
    main()
