"""Scalable GraphSAGE: one sampled hop and the activation cache
(counterpart of examples/scalable_sage/run_scalable_sage.py:16-86, with
the same defaults).

    python -m euler_tpu_torch.examples.run_scalable_sage [--device_sampler \\
        [--encoder gcn] [--no-cache_refresh]] [--dataset cora] [--seed 0] \\
        [--device cpu]

Without --device_sampler the input is host-fed: FanoutDataFlow draws
each batch's one hop on the engine and ships its features, and
ScalableGraphSage trains through NodeEstimator, its float32 cache read
with gather_mean (the sage encoder only: --encoder gcn exits, as the
reference does). With --device_sampler DeviceSampledScalableSage draws
the hop on the device, its cache refreshed over all nodes before each
evaluation unless --no-cache_refresh (models.graphsage.
refresh_act_cache). Prints the result dict of fit_citation. The graph
is get_dataset(dataset).engine. --seed seeds the engine's draws, the
model's init and dropout.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import fit_citation, load_graph
from euler_tpu_torch.models.graphsage import (
    DeviceSampledScalableSage, ScalableGraphSage, refresh_act_cache,
)
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden_dim", type=int, default=32)
    ap.add_argument("--num_layers", type=int, default=2)
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=200)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--encoder", default="sage", choices=["sage", "gcn"],
                    help="sage (concat) or gcn (mean of self and "
                         "neighbors)")
    ap.add_argument("--device_sampler", action="store_true",
                    help="sampling and the activation cache on the "
                         "device, with a full-coverage cache refresh "
                         "before each evaluation")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--store_decay", type=float, default=0.9)
    ap.add_argument("--cache_refresh", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="refresh the cache over all nodes before each "
                         "evaluation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def build_estimator(args, data, dev) -> NodeEstimator:
    """The runner's NodeEstimator over data's engine on dev: host-fed
    ScalableGraphSage over FanoutDataFlow (one hop of args.fanout), or
    with args.device_sampler DeviceSampledScalableSage over tables built
    from the engine, its cache refreshed before each evaluation unless
    --no-cache_refresh."""
    g = data.engine
    d = data.feature_dim
    init = torch.Generator().manual_seed(args.seed)
    params = dict(batch_size=args.batch_size,
                  learning_rate=args.learning_rate, seed=args.seed)
    store = sampler = flow = None
    if args.device_sampler:
        store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                                   label_dim=data.num_classes, device=dev)
        sampler = DeviceNeighborTable(g, cap=args.sampler_cap, device=dev)
        model = DeviceSampledScalableSage(
            data.num_classes, d, multilabel=data.multilabel,
            dim=args.hidden_dim, fanout=args.fanout,
            num_layers=args.num_layers, max_id=sampler.pad_row,
            store_decay=args.store_decay, encoder=args.encoder,
            generator=init)
    else:
        model = ScalableGraphSage(
            data.num_classes, d, multilabel=data.multilabel,
            dim=args.hidden_dim, num_layers=args.num_layers,
            max_id=data.max_id, generator=init)
        flow = FanoutDataFlow(g, [args.fanout], feature_ids=["feature"])
        # the reference's params: ids become rows modulo max_id + 1
        params["max_id"] = data.max_id
    est = NodeEstimator(
        model, params, g, flow, label_fid="label",
        label_dim=data.num_classes, model_dir=args.model_dir or None,
        feature_store=store, device_sampler=sampler, device=dev)
    if args.device_sampler and args.cache_refresh:
        est.pre_eval_hook = refresh_act_cache
    return est


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if not args.device_sampler and args.encoder != "sage":
        raise SystemExit("--encoder gcn requires --device_sampler "
                         "(the host example is the sage variant)")
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    res = fit_citation(build_estimator(args, data, dev), args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res

if __name__ == "__main__":
    main()
