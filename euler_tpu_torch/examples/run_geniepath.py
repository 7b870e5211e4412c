"""GeniePath on device-resident tables (counterpart of
examples/geniepath/run_geniepath.py:16-81, its --device_sampler branch,
with the same defaults).

    python -m euler_tpu_torch.examples.run_geniepath --device_sampler \\
        [--dataset cora] [--seed 0] [--device cpu]

Trains DeviceSampledGraphSage(encoder='genie') through NodeEstimator and
prints the result dict of fit_citation (test_metric is the test split's
micro-F1 at the best-val weights). --learning_rate 0 (the default)
means 0.01 on cora and 0.003 elsewhere, as in the reference. The tables
come from get_dataset(dataset).engine. --seed seeds the engine's root
draws, the model's init and dropout. Without --device_sampler the
runner raises: the host-fed GeniePath model is not ported yet
(ROADMAP.md Queue A, 'Engine binding').
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import fit_citation, load_graph
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--fanouts", default="15,10")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.0,
                    help="0 = 0.01 on cora, 0.003 elsewhere")
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--weight_decay", type=float, default=0.005)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--device_sampler", action="store_true",
                    help="sample fanouts on the device (the only path "
                         "ported)")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if not args.device_sampler:
        raise NotImplementedError(
            "the host-fed GeniePath model is not ported yet: ROADMAP.md "
            "Queue A, 'Engine binding'; pass --device_sampler")
    if not args.learning_rate:
        args.learning_rate = 0.01 if args.dataset == "cora" else 0.003
    dev = resolve_device(args.device)
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    data = load_graph(args.dataset, args.seed)
    g = data.engine
    d = data.feature_dim
    store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                               label_dim=data.num_classes, device=dev)
    sampler = DeviceNeighborTable(g, cap=args.sampler_cap, device=dev)
    model = DeviceSampledGraphSage(
        data.num_classes, d, multilabel=False, dim=args.hidden_dim,
        fanouts=fanouts, encoder="genie", dropout=args.dropout,
        generator=torch.Generator().manual_seed(args.seed))
    est = NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        g, None, label_fid="label", label_dim=data.num_classes,
        model_dir=args.model_dir or None, feature_store=store,
        device_sampler=sampler, device=dev)
    res = fit_citation(est, args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
