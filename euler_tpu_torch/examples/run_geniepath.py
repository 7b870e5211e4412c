"""GeniePath (counterpart of examples/geniepath/run_geniepath.py:16-81,
with the same defaults).

    python -m euler_tpu_torch.examples.run_geniepath [--device_sampler] \\
        [--dataset cora] [--seed 0] [--device cpu]

Without --device_sampler the input is host-fed: FanoutDataFlow draws
each batch's fanout on the engine and ships its features, and the
runner's own GeniePathModel (a SuperviseModel over a GenieEncoder named
"enc", as the reference runner defines it) trains through NodeEstimator.
With --device_sampler the tables are built from the engine and
DeviceSampledGraphSage(encoder='genie') draws the fanout on the device.
Prints the result dict of fit_citation (test_metric is the test split's
micro-F1 at the best-val weights). --learning_rate 0 (the default)
means 0.01 on cora and 0.003 elsewhere, as in the reference.
--seed seeds the engine's draws, the model's init and dropout.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.dataflow import FanoutDataFlow
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import fit_citation, load_graph
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.platform import resolve_device
from euler_tpu_torch.utils.encoders import GenieEncoder


class GeniePathModel(SuperviseModel):
    """The reference runner's host-fed model: a GenieEncoder ("enc")
    over the batch's feature layers, then SuperviseModel's logits."""

    def __init__(self, num_classes: int, in_dim: int, dim: int,
                 fanouts: Sequence[int], multilabel: bool = True,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        enc = GenieEncoder(in_dim, dim, fanouts, generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         dropout=dropout, generator=generator)
        self.enc = enc

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.enc(batch["layers"])


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
                    help="sample fanouts on the device from tables built "
                         "from the engine")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def build_estimator(args, data, dev) -> NodeEstimator:
    """The runner's NodeEstimator over data's engine on dev: host-fed
    GeniePathModel over FanoutDataFlow, or with args.device_sampler
    DeviceSampledGraphSage(encoder='genie') over tables built from the
    engine."""
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    g = data.engine
    d = data.feature_dim
    init = torch.Generator().manual_seed(args.seed)
    store = sampler = flow = None
    if args.device_sampler:
        store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                                   label_dim=data.num_classes, device=dev)
        sampler = DeviceNeighborTable(g, cap=args.sampler_cap, device=dev)
        model = DeviceSampledGraphSage(
            data.num_classes, d, multilabel=data.multilabel,
            dim=args.hidden_dim, fanouts=fanouts, encoder="genie",
            dropout=args.dropout, generator=init)
    else:
        model = GeniePathModel(data.num_classes, d, args.hidden_dim,
                               fanouts, multilabel=data.multilabel,
                               dropout=args.dropout, generator=init)
        flow = FanoutDataFlow(g, list(fanouts), feature_ids=["feature"])
    return NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        g, flow, label_fid="label", label_dim=data.num_classes,
        model_dir=args.model_dir or None, feature_store=store,
        device_sampler=sampler, device=dev)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The runner's flags, --learning_rate 0 resolved per dataset."""
    args = build_parser().parse_args(argv)
    if not args.learning_rate:
        args.learning_rate = 0.01 if args.dataset == "cora" else 0.003
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    data = load_graph(args.dataset, args.seed)
    res = fit_citation(build_estimator(args, data, dev), args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res

if __name__ == "__main__":
    main()
