"""GraphSAGE on device-resident tables (counterpart of
examples/graphsage/run_graphsage.py:19-171, its --device_sampler
branches, with the same defaults).

    python -m euler_tpu_torch.examples.run_graphsage --device_sampler \\
        [--mode unsupervised] [--int8_features] [--dataset cora] \\
        [--aggregator mean] [--fused_sampler] \\
        [--act_cache [--store_decay 0.9] [--no-cache_refresh]] \\
        [--seed 0] [--device cpu]

Supervised (the default mode) prints the result dict of fit_citation
(test_metric is the test split's micro-F1 at the best-val weights);
--act_cache trains DeviceSampledScalableSage instead (one sampled hop of
fanouts[0], len(fanouts) layers, the activation cache refreshed over all
nodes before each evaluation unless --no-cache_refresh). --mode
unsupervised trains DeviceSampledUnsupervisedSage with a plain
BaseEstimator on roots drawn over all nodes, train(max_steps) then
evaluate(eval_steps), and prints the train_*/eval_* dict (eval_metric
is the MRR). --fused_sampler places the fused [N+1, 2C] neighbor table.
--seed seeds the model's init, the root draws and dropout (the
reference's estimator seed, default 0). Without --device_sampler the
runner raises: the host-fed path needs the graph engine (ROADMAP.md
Queue A, 'Engine binding').
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch.dataset import get_dataset
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import (
    fit_citation, root_input_fn, train_then_evaluate,
)
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledScalableSage,
    DeviceSampledUnsupervisedSage, refresh_act_cache,
)
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--mode", default="supervised",
                    choices=["supervised", "unsupervised"])
    ap.add_argument("--fanouts", default="10,10")
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--aggregator", default="mean")
    ap.add_argument("--device_sampler", action="store_true",
                    help="sample fanouts on the device (the only path "
                         "ported)")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--fused_sampler", action="store_true",
                    help="one fused [N+1, 2C] neighbor table, one row "
                         "gather per hop")
    ap.add_argument("--int8_features", action="store_true",
                    help="int8 feature table with a float32 per-column "
                         "scale")
    ap.add_argument("--act_cache", action="store_true",
                    help="supervised: DeviceSampledScalableSage, one "
                         "sampled hop and the activation cache")
    ap.add_argument("--store_decay", type=float, default=0.9,
                    help="with --act_cache: EMA weight on the old cached "
                         "activation")
    ap.add_argument("--cache_refresh", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --act_cache: refresh the cache over all "
                         "nodes before each evaluation")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_negs", type=int, default=5)
    ap.add_argument("--learning_rate", type=float, default=0.003)
    ap.add_argument("--dropout", type=float, default=0.6)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--eval_steps", type=int, default=20,
                    help="unsupervised: batches evaluated after training")
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if not args.device_sampler:
        raise NotImplementedError(
            "the host-fed sampler needs the graph engine, not ported yet: "
            "ROADMAP.md Queue A, 'Engine binding'; pass --device_sampler")
    dev = resolve_device(args.device)
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    data = get_dataset(args.dataset)
    print(f"dataset {args.dataset}: {data.num_nodes} nodes, "
          f"{data.neighbors.size} directed edges [synthetic]", flush=True)
    d = data.features.shape[1]
    feats = np.concatenate([data.features, np.zeros((1, d), np.float32)])
    quantize = "int8" if args.int8_features else None
    sampler = DeviceNeighborTable.from_csr(data.offsets, data.neighbors,
                                           cap=args.sampler_cap, device=dev,
                                           fused=args.fused_sampler)
    init = torch.Generator().manual_seed(args.seed)
    if args.mode == "unsupervised":
        store = DeviceFeatureStore.from_arrays(feats, quantize=quantize,
                                               device=dev)
        neg = DeviceNodeSampler.from_arrays(
            np.ones(data.num_nodes, np.float32), device=dev)
        model = DeviceSampledUnsupervisedSage(
            sampler.pad_row, d, dim=args.hidden_dim, fanouts=fanouts,
            aggregator=args.aggregator, num_negs=args.num_negs,
            generator=init)
        est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                        seed=args.seed),
                            model_dir=args.model_dir or None, device=dev)
        est.static_batch.update({"feature_table": store.features,
                                 **sampler.tables, **neg.tables})
        if store.feature_scale is not None:
            est.static_batch["feature_scale"] = store.feature_scale
        res = train_then_evaluate(
            est, root_input_fn(data.num_nodes, args.batch_size, args.seed),
            args.max_steps, args.eval_steps)
        print(res, flush=True)
        return res
    labels = np.concatenate([data.onehot_labels(),
                             np.zeros((1, data.num_classes), np.float32)])
    store = DeviceFeatureStore.from_arrays(feats, labels, quantize=quantize,
                                           device=dev)
    if args.act_cache:
        model = DeviceSampledScalableSage(
            data.num_classes, d, multilabel=False, dim=args.hidden_dim,
            fanout=fanouts[0], num_layers=len(fanouts),
            max_id=sampler.pad_row, dropout=args.dropout,
            store_decay=args.store_decay, generator=init)
    else:
        model = DeviceSampledGraphSage(
            data.num_classes, d, multilabel=False, dim=args.hidden_dim,
            fanouts=fanouts, aggregator=args.aggregator,
            dropout=args.dropout, generator=init)
    est = NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        data.node_types, store, sampler, model_dir=args.model_dir or None,
        device=dev)
    if args.act_cache and args.cache_refresh:
        est.pre_eval_hook = refresh_act_cache
    res = fit_citation(est, args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
