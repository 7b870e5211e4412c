"""The citation protocol (counterpart of examples/common.py:84-113)."""

from __future__ import annotations

from typing import Any, Dict


def fit_citation(est, max_steps: int) -> Dict[str, Any]:
    """Early-stop on the val split (node type 1), then report the test
    split (type 2) at the best-val weights. Model selection and the test
    metric both come from deterministic full-split sweeps (each node
    once, padded tail masked)."""
    res = est.train_and_evaluate(
        est.train_input_fn, est.eval_sweep_input_fn, max_steps,
        est.eval_sweep_steps(), eval_every=max(max_steps // 10, 10),
        keep_best=True)
    test = est.evaluate(lambda: est.eval_sweep_input_fn(node_type=2),
                        est.eval_sweep_steps(node_type=2))
    res["test_metric"] = test["metric"]
    res["test_loss"] = test["loss"]
    return res
