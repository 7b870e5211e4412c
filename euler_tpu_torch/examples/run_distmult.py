"""DistMult on the fb15k family: the TransX runner with the trilinear
scorer (counterpart of examples/distmult/run_distmult.py).

    python -m euler_tpu_torch.examples.run_distmult [--dataset fb15k237] \\
        [--seed 0] [--device cpu]

Takes run_transx's flags; --model defaults to DistMult.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from euler_tpu_torch.examples import run_transx


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    return run_transx.main(argv, model="DistMult")


if __name__ == "__main__":
    main()
