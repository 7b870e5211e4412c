"""GraphSAGE, supervised and unsupervised (counterpart of
examples/graphsage/run_graphsage.py:19-190, with the same defaults).

    python -m euler_tpu_torch.examples.run_graphsage \\
        [--mode unsupervised] [--dataset cora] [--device_sampler \\
        [--int8_features] [--aggregator mean] [--fused_sampler] \\
        [--act_cache [--store_decay 0.9] [--no-cache_refresh]]] \\
        [--seed 0] [--device cpu]

The graph is get_dataset(dataset).engine. Without --device_sampler the
input is host-fed: FanoutDataFlow draws each batch's fanout on the
engine and ships its features; supervised mode trains
SupervisedGraphSage in a NodeEstimator, unsupervised mode
UnsupervisedGraphSage in an EdgeEstimator (positive edges and negatives
from the engine; train_and_evaluate). With --device_sampler the tables
are built from the engine (DeviceFeatureStore, DeviceNeighborTable) and
the fanout is drawn on the device: supervised DeviceSampledGraphSage
(--act_cache: DeviceSampledScalableSage, one sampled hop of fanouts[0],
len(fanouts) layers, the activation cache refreshed over all nodes
before each evaluation unless --no-cache_refresh), unsupervised
DeviceSampledUnsupervisedSage in a plain BaseEstimator on roots drawn
over all nodes, train(max_steps) then evaluate(eval_steps).

Supervised mode prints the result dict of fit_citation (test_metric is
the test split's micro-F1 at the best-val weights); unsupervised mode
prints the train_*/eval_* dict (eval_metric is the MRR). --seed seeds
the engine's draws, the model's init and dropout (the reference's
estimator seed, default 0).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.estimator.base_estimator import BaseEstimator
from euler_tpu_torch.estimator.estimators import EdgeEstimator, NodeEstimator
from euler_tpu_torch.examples.common import (
    fit_citation, load_graph, root_input_fn, train_then_evaluate,
)
from euler_tpu_torch.models.graphsage import (
    DeviceSampledGraphSage, DeviceSampledScalableSage,
    DeviceSampledUnsupervisedSage, SupervisedGraphSage,
    UnsupervisedGraphSage, refresh_act_cache,
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
                    help="sample fanouts on the device from tables built "
                         "from the engine")
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
    if args.act_cache and not args.device_sampler:
        raise SystemExit("run_graphsage: --act_cache needs "
                         "--device_sampler (the cache config is the "
                         "device path)")
    dev = resolve_device(args.device)
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    data = load_graph(args.dataset, args.seed)
    g = data.engine
    d = data.feature_dim
    init = torch.Generator().manual_seed(args.seed)
    quantize = "int8" if args.int8_features else None
    flow = FanoutDataFlow(g, list(fanouts), feature_ids=["feature"])
    if args.mode == "unsupervised":
        if args.device_sampler:
            res = _device_unsupervised(args, g, d, fanouts, quantize, init,
                                       dev)
        else:
            model = UnsupervisedGraphSage(
                d, args.hidden_dim, data.max_id, fanouts=fanouts,
                aggregator=args.aggregator, num_negs=args.num_negs,
                generator=init)
            est = EdgeEstimator(
                model, dict(batch_size=args.batch_size,
                            num_negs=args.num_negs,
                            learning_rate=args.learning_rate,
                            max_id=data.max_id, seed=args.seed),
                g, dataflow=flow, model_dir=args.model_dir or None,
                device=dev)
            res = est.train_and_evaluate(
                est.train_input_fn, est.eval_input_fn, args.max_steps,
                args.eval_steps)
            res.pop("train_losses", None)
        print(res, flush=True)
        return res
    store = sampler = None
    if args.device_sampler:
        store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                                   label_dim=data.num_classes,
                                   quantize=quantize, device=dev)
        sampler = DeviceNeighborTable(g, cap=args.sampler_cap,
                                      fused=args.fused_sampler, device=dev)
        if args.act_cache:
            model = DeviceSampledScalableSage(
                data.num_classes, d, multilabel=data.multilabel,
                dim=args.hidden_dim, fanout=fanouts[0],
                num_layers=len(fanouts), max_id=sampler.pad_row,
                dropout=args.dropout, store_decay=args.store_decay,
                generator=init)
        else:
            model = DeviceSampledGraphSage(
                data.num_classes, d, multilabel=data.multilabel,
                dim=args.hidden_dim, fanouts=fanouts,
                aggregator=args.aggregator, dropout=args.dropout,
                generator=init)
    else:
        model = SupervisedGraphSage(
            data.num_classes, d, multilabel=data.multilabel,
            dim=args.hidden_dim, fanouts=fanouts,
            aggregator=args.aggregator, dropout=args.dropout,
            generator=init)
    est = NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        g, flow, label_fid="label", label_dim=data.num_classes,
        model_dir=args.model_dir or None, feature_store=store,
        device_sampler=sampler, device=dev)
    if args.act_cache and args.cache_refresh:
        est.pre_eval_hook = refresh_act_cache
    res = fit_citation(est, args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


def _device_unsupervised(args, g, d, fanouts, quantize, init, dev):
    """The fully on-device unsupervised path: the fanout embedding, the
    positive one-hop draw and the weighted negatives inside the step."""
    store = DeviceFeatureStore(g, ["feature"], quantize=quantize,
                               device=dev)
    tab = DeviceNeighborTable(g, cap=args.sampler_cap,
                              fused=args.fused_sampler, device=dev)
    neg = DeviceNodeSampler(g, node_type=-1, device=dev)
    model = DeviceSampledUnsupervisedSage(
        tab.pad_row, d, dim=args.hidden_dim, fanouts=fanouts,
        aggregator=args.aggregator, num_negs=args.num_negs, generator=init)
    est = BaseEstimator(model, dict(learning_rate=args.learning_rate,
                                    seed=args.seed),
                        model_dir=args.model_dir or None, device=dev)
    est.static_batch.update({"feature_table": store.features,
                             **tab.tables, **neg.tables})
    if store.feature_scale is not None:
        est.static_batch["feature_scale"] = store.feature_scale
    return train_then_evaluate(
        est, root_input_fn(g, args.batch_size, store.pad_row),
        args.max_steps, args.eval_steps)


if __name__ == "__main__":
    main()
