"""FastGCN, the layerwise importance-sampled GCN (counterpart of
examples/fastgcn/run_fastgcn.py, with the same defaults).

    python -m euler_tpu_torch.examples.run_fastgcn [--dataset cora] \\
        [--device_sampler] [--seed 0] [--device cpu]

Without --device_sampler the engine draws each batch's layer pools on
the host (LayerwiseDataFlow) and FastGCNModel (LayerEncoder "enc")
trains on the shipped levels and adjacencies. With --device_sampler the
features and labels go to device tables (DeviceFeatureStore,
DeviceNeighborTable from the engine) and DeviceSampledLayerwiseGCN
draws the pools on the device. Both evaluate as the FastGCN protocol
does, on exact 1-hop closures built on the host
(LayerwiseDataFlow(sample=False); NodeEstimator's eval_via_flow with
the device sampler). Prints the result dict of fit_citation (test_metric
is the test split's micro-F1 at the best-val weights). --layer_sizes ''
(the default) means 256,256 on pubmed and 128,128 elsewhere, --max_steps
0 means 1200 on pubmed and 800 elsewhere. --seed seeds the engine's
draws, the init and the dropout.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from euler_tpu_torch.dataflow import LayerwiseDataFlow
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.examples.common import fit_citation, load_graph
from euler_tpu_torch.models.graphsage import DeviceSampledLayerwiseGCN
from euler_tpu_torch.mp_utils.base import SuperviseModel
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.platform import resolve_device
from euler_tpu_torch.utils.encoders import LayerEncoder


class FastGCNModel(SuperviseModel):
    """The reference runner's host-fed model: LayerEncoder ("enc") over
    the batch's layers and adjs, then the dense head."""

    def __init__(self, num_classes: int, in_dim: int, dim: int,
                 num_layers: int, dropout: float, multilabel: bool = False,
                 generator: Optional[torch.Generator] = None):
        enc = LayerEncoder(in_dim, dim, num_layers, dropout=dropout,
                           generator=generator)
        super().__init__(num_classes, multilabel, enc.out_dim,
                         generator=generator)
        self.enc = enc

    def embed(self, batch: Dict[str, Any]) -> torch.Tensor:
        return self.enc(batch["layers"], batch["adjs"],
                        batch.get("dropout_generator"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--hidden_dim", type=int, default=32)
    ap.add_argument("--layer_sizes", default="",
                    help="default: 256,256 on pubmed, 128,128 otherwise")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--learning_rate", type=float, default=0.01)
    ap.add_argument("--max_steps", type=int, default=0)
    ap.add_argument("--eval_steps", type=int, default=20)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--weight_decay", type=float, default=0.005)
    ap.add_argument("--model_dir", default="")
    ap.add_argument("--device_sampler", action="store_true",
                    help="draw the layer pools on the device "
                         "(DeviceSampledLayerwiseGCN); evaluation keeps "
                         "the host's exact-closure protocol")
    ap.add_argument("--sampler_cap", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default CUDA")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    if not args.layer_sizes:
        args.layer_sizes = ("256,256" if args.dataset == "pubmed"
                            else "128,128")
    if not args.max_steps:
        args.max_steps = 1200 if args.dataset == "pubmed" else 800
    dev = resolve_device(args.device)
    sizes = [int(x) for x in args.layer_sizes.split(",")]
    data = load_graph(args.dataset, args.seed)
    g = data.engine
    gen = torch.Generator().manual_seed(args.seed)
    store = sampler = flow = None
    if args.device_sampler:
        store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                                   label_dim=data.num_classes, device=dev)
        sampler = DeviceNeighborTable(g, cap=args.sampler_cap, device=dev)
        model = DeviceSampledLayerwiseGCN(
            data.num_classes, data.feature_dim, multilabel=data.multilabel,
            dim=args.hidden_dim, layer_sizes=tuple(sizes),
            layer_dropout=args.dropout, generator=gen)
    else:
        model = FastGCNModel(data.num_classes, data.feature_dim,
                             args.hidden_dim, len(sizes), args.dropout,
                             multilabel=data.multilabel, generator=gen)
        flow = LayerwiseDataFlow(g, sizes, feature_ids=["feature"])
    # the FastGCN protocol in both modes: sampled pools for training,
    # exact 1-hop closures (the full propagation matrix) for evaluation
    eval_flow = LayerwiseDataFlow(g, sizes, sample=False,
                                  feature_ids=["feature"])
    est = NodeEstimator(
        model, dict(batch_size=args.batch_size,
                    learning_rate=args.learning_rate,
                    weight_decay=args.weight_decay, seed=args.seed),
        g, flow, label_fid="label", label_dim=data.num_classes,
        model_dir=args.model_dir or None, feature_store=store,
        eval_dataflow=eval_flow, device_sampler=sampler,
        eval_via_flow=args.device_sampler, device=dev)
    res = fit_citation(est, args.max_steps)
    res.pop("train_losses", None)
    print(res, flush=True)
    return res


if __name__ == "__main__":
    main()
