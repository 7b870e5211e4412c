"""The runners' shared protocols: the citation protocol (counterpart of
examples/common.py:84-113), the unsupervised runners' input and
train-then-evaluate (examples/{graphsage,deepwalk,line}/run_*.py, their
`--device_sampler` branches), and the engine graph every runner reads."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator

import numpy as np

from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.graph import seed as seed_engine


def load_graph(name: str, seed: int):
    """get_dataset(name) with the engine's sampler seeded (on this
    thread) to `seed`, as the runners' --seed moves the engine's draws;
    prints the dataset line."""
    data = get_dataset(name)
    seed_engine(seed)
    g = data.engine
    print(f"dataset {name}: {g.node_count} nodes, {g.edge_count} directed "
          f"edges [{data.source}]", flush=True)
    return data


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


def root_input_fn(graph, batch_size: int, missing: int):
    """The unsupervised runners' input (counterpart of their
    `--device_sampler` input_fn): each batch holds `batch_size` roots
    drawn by the engine's sample_node over all nodes, as engine rows
    (an id the engine lacks → `missing`, the pad row), and a sample_seed
    counting up from 1. The counter goes on across calls, as the
    reference's does, so evaluate's batches follow train's."""
    counter = itertools.count(1)

    def input_fn() -> Iterator[Dict[str, Any]]:
        while True:
            roots = graph.node_rows(graph.sample_node(batch_size, -1),
                                    missing=missing)
            yield {"rows": [roots], "infer_ids": roots,
                   "sample_seed": np.uint32(next(counter))}

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
