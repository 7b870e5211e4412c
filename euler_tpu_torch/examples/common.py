"""The runners' shared protocols: the citation protocol (counterpart of
examples/common.py:84-113) and the unsupervised runners' input and
train-then-evaluate (examples/{graphsage,deepwalk,line}/run_*.py, their
`--device_sampler` branches)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator

import numpy as np


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


def root_input_fn(num_nodes: int, batch_size: int, seed: int):
    """The unsupervised runners' input (counterpart of their
    `--device_sampler` input_fn): each batch holds `batch_size` root
    rows drawn uniformly, with replacement, over all nodes, and a
    sample_seed counting up from 1. The reference draws the roots with
    its graph engine's sample_node over unit-weight nodes; the port has
    no engine and draws them from a numpy Generator seeded with (seed,
    0). The generator and the counter go on across calls, as the
    reference's do, so evaluate's batches follow train's."""
    rng = np.random.default_rng([seed, 0])
    counter = itertools.count(1)

    def input_fn() -> Iterator[Dict[str, Any]]:
        while True:
            roots = rng.integers(0, num_nodes, batch_size).astype(np.int32)
            yield {"rows": [roots], "sample_seed": np.uint32(next(counter))}

    return input_fn


def train_then_evaluate(est, input_fn, max_steps: int,
                        eval_steps: int) -> Dict[str, Any]:
    """train(max_steps), then evaluate(eval_steps) on the same input, as
    a dict of train_* and eval_* entries (the per-step losses left
    out)."""
    res = est.train(input_fn, max_steps)
    res.pop("losses")
    ev = est.evaluate(input_fn, eval_steps)
    return {**{f"train_{k}": v for k, v in res.items()},
            **{f"eval_{k}": v for k, v in ev.items()}}
