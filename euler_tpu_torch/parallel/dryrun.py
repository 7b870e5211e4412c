"""One SPMD training step of each multi-device input path on an n-rank
('data', 'model') mesh (counterpart of __graft_entry__.py:53-396,
dryrun_multichip): model parallelism 2 when n is even (1 otherwise),
the rest data parallelism, tiny shapes.

Six legs, as the reference's:

1. cluster-fed: ShardedSupervisedGraphSage (id embedding row-sharded
   over 'model') through spmd_init + make_spmd_train_step on a synthetic
   batch, then on a batch pulled from a 2-shard graph service;
2. device-sampled: DeviceSampledGraphSage over feature, label and
   neighbor tables row-sharded over 'model', roots over 'data';
3. device-layerwise: DeviceSampledLayerwiseGCN over an int8 feature
   table (replicated tables);
4. fused + row-sharded: leg 2's model over the fused table row-sharded;
5. device-walk: DeviceSampledSkipGram over the row-sharded walk tables;
6. act-cache: DeviceSampledScalableSage over the row-sharded tables with
   its activation cache row-sharded too; the step's writes must land.

Every rank runs dryrun_multichip in a running process group. Launch:

    torchrun --nproc_per_node N -m euler_tpu_torch.parallel.dryrun
    python -m euler_tpu_torch.parallel.dryrun --nproc 4 --device cpu

(the second spawns N local ranks; gloo on the CPU, NCCL on the cards).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch.parallel import collectives

FANOUTS = (4, 4)
FEAT_DIM, NUM_CLASSES = 8, 4


def _log(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def tiny_fanout_batch(batch: int, fanouts, feat_dim: int, num_classes: int,
                      max_id: int, seed: int = 0) -> Dict:
    """The reference's _tiny_fanout_batch (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    sizes = [batch]
    for k in fanouts:
        sizes.append(sizes[-1] * k)
    layers = [rng.normal(0, 1, (s, feat_dim)).astype(np.float32)
              for s in sizes]
    ids = [rng.integers(0, max_id + 1, s).astype(np.int32) for s in sizes]
    labels = np.eye(num_classes, dtype=np.float32)[
        rng.integers(0, num_classes, batch)]
    return {"layers": layers, "ids": ids, "labels": labels}


def cluster_fanout_batch(batch: int, fanouts, feat_dim: int,
                         num_classes: int, max_id: int) -> Dict:
    """Dump a tiny graph, serve it from 2 in-process shards and pull one
    fanout batch through RemoteGraphEngine (the reference's
    _cluster_fanout_batch)."""
    import shutil
    import tempfile

    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.gql import start_service
    from euler_tpu_torch.graph import GraphBuilder, RemoteGraphEngine, seed

    seed(11)
    b = GraphBuilder()
    b.set_num_types(1, 1)
    b.set_feature(0, 0, feat_dim, "feature")
    b.set_feature(1, 0, num_classes, "label")
    n = 32
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b.add_nodes(ids)
    b.add_edges(np.concatenate([ids, ids]),
                np.concatenate([np.roll(ids, -1), np.roll(ids, -2)]))
    rng = np.random.default_rng(2)
    cls = (ids % num_classes).astype(np.int64)
    b.set_node_dense(ids, 0,
                     rng.normal(0, 1, (n, feat_dim)).astype(np.float32))
    b.set_node_dense(ids, 1, np.eye(num_classes, dtype=np.float32)[cls])
    g = b.finalize()
    data_dir = tempfile.mkdtemp(prefix="etg_dryrun_")
    g.dump(data_dir, num_partitions=2)
    servers = [start_service(data_dir, shard_idx=i, shard_num=2, port=0)
               for i in range(2)]
    eps = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    remote = RemoteGraphEngine(f"hosts:{eps}", seed=5)
    try:
        flow = FanoutDataFlow(remote, list(fanouts),
                              feature_ids=["feature"])
        roots = remote.sample_node(batch, -1)
        fb = flow(roots)
        return {
            "ids": [(i.astype(np.int64) % (max_id + 1)).astype(np.int32)
                    for i in fb["ids"]],
            "layers": fb["layers"],
            "labels": remote.get_dense_feature(roots, "label"),
        }
    finally:
        remote.close()
        for s in servers:
            s.stop()
        shutil.rmtree(data_dir, ignore_errors=True)


def _rank0_batch(make) -> Dict:
    """make() on rank 0, broadcast to every rank."""
    box = [make() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _loss(model, batch, mesh, train: bool = False) -> float:
    """The global batch's loss of one forward (and backward when
    training) on this rank's slice."""
    model.train(train)
    with collectives.data_parallel(mesh):
        out = model(batch)
    if train:
        out.loss.backward()
    loss = out.loss.detach().clone()
    if mesh.size("data") > 1:
        collectives.all_reduce(loss, mesh.group("data"))
    return float(loss)


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """The six legs on a mesh of this process group's n_devices ranks
    (every rank calls it). device None: CUDA + NCCL; "cpu": gloo.
    Returns each leg's global loss."""
    from euler_tpu_torch.dataset import engine_from_arrays
    from euler_tpu_torch.dataset.synthetic import synthetic_citation
    from euler_tpu_torch.graph import seed as engine_seed
    from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
    from euler_tpu_torch.models.graphsage import (
        DeviceSampledGraphSage, DeviceSampledLayerwiseGCN,
        DeviceSampledScalableSage, ShardedSupervisedGraphSage, shard_caches,
    )
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from euler_tpu_torch.parallel.placement import row_shard
    from euler_tpu_torch.parallel.train import (
        make_spmd_train_step, spmd_init,
    )
    from euler_tpu_torch.utils import optimizers as opt_lib

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) in a world of "
                           f"{dist.get_world_size()} ranks")
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(model_parallel, device=device)
    shard = model_parallel > 1
    dp = mesh.size("data")
    batch = max(2 * dp, 8)
    out: Dict[str, float] = {}

    # 1. cluster-fed SPMD step: data parallelism + the id embedding's rows
    # over 'model'
    max_id = 64 * model_parallel - 1
    model = ShardedSupervisedGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=16, fanouts=FANOUTS,
        max_id=max_id, id_dim=8, generator=torch.Generator().manual_seed(0))
    state = spmd_init(model, lambda ps: opt_lib.get("adam", ps, 1e-3), mesh)
    step = make_spmd_train_step(mesh)
    example = tiny_fanout_batch(batch, FANOUTS, FEAT_DIM, NUM_CLASSES,
                                max_id)
    state, loss, metric = step(state, shard_batch(example, mesh))
    out["spmd"] = float(loss)
    _log(f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
         f"loss={out['spmd']:.4f} metric={float(metric):.4f}")
    cl = _rank0_batch(lambda: cluster_fanout_batch(
        batch, FANOUTS, FEAT_DIM, NUM_CLASSES, max_id))
    state, loss, _ = step(state, shard_batch(cl, mesh))
    out["cluster"] = float(loss)
    _log(f"dryrun_multichip({n_devices}): cluster-fed step "
         f"loss={out['cluster']:.4f}")

    # 2. device-sampled, tables row-sharded over 'model'
    engine_seed(4)
    g3 = engine_from_arrays(synthetic_citation(
        n=64, d=FEAT_DIM, num_classes=NUM_CLASSES, train_per_class=8,
        val=8, test=8, seed=4)).engine
    store = DeviceFeatureStore(g3, ["feature"], label_fid="label",
                               label_dim=NUM_CLASSES, mesh=mesh,
                               shard_rows=shard)
    samp = DeviceNeighborTable(g3, cap=8, mesh=mesh, shard_rows=shard)
    if shard:
        # each rank holds 1/mp of the rows
        info = row_shard(samp.neighbors)
        assert info.rows * model_parallel == info.global_rows \
            and info.rows < info.global_rows, info
    tm = mesh if shard else None
    ds_model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=16, fanouts=FANOUTS,
        table_mesh=tm, generator=torch.Generator().manual_seed(1)).to(
        mesh.device)
    roots = store.lookup(g3.sample_node(batch, -1)).astype(np.int32)
    b3 = shard_batch({"rows": [roots], "sample_seed": 1}, mesh)
    batch3 = {**b3, "feature_table": store.features,
              "label_table": store.labels, **samp.tables}
    out["device_sampled"] = _loss(ds_model, batch3, mesh)
    where = "row-sharded over model" if shard else "replicated"
    _log(f"dryrun_multichip({n_devices}): device-sampled step "
         f"loss={out['device_sampled']:.4f} (tables {where})")

    # 3. device layerwise over an int8 feature table, replicated tables
    store4 = DeviceFeatureStore(g3, ["feature"], label_fid="label",
                                label_dim=NUM_CLASSES, mesh=mesh,
                                quantize="int8")
    samp4 = DeviceNeighborTable(g3, cap=8, mesh=mesh)
    lw_model = DeviceSampledLayerwiseGCN(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=16, layer_sizes=(8, 8),
        generator=torch.Generator().manual_seed(2)).to(mesh.device)
    batch4 = {**b3, "sample_seed": 2, "feature_table": store4.features,
              "feature_scale": store4.feature_scale,
              "label_table": store4.labels, **samp4.tables}
    out["layerwise"] = _loss(lw_model, batch4, mesh)
    _log(f"dryrun_multichip({n_devices}): device-layerwise step "
         f"loss={out['layerwise']:.4f} (int8 feature table)")

    # 4. the fused table row-sharded over 'model'
    if shard:
        samp_fs = DeviceNeighborTable(g3, cap=8, mesh=mesh,
                                      shard_rows=True, fused=True)
        info = row_shard(samp_fs.fused_table)
        assert info.rows * model_parallel == info.global_rows, info
        batch3b = {k: v for k, v in batch3.items()
                   if k not in ("nbr_table", "cum_table")}
        batch3b.update(samp_fs.tables)
        out["fused_sharded"] = _loss(ds_model, batch3b, mesh)
        _log(f"dryrun_multichip({n_devices}): fused+row-sharded sampling "
             f"step loss={out['fused_sharded']:.4f} (per-rank fused shard "
             f"{info.rows}/{info.global_rows} rows)")

    # 5. the walk family over the row-sharded walk tables
    wk = samp if shard else samp4
    wk_model = DeviceSampledSkipGram(
        num_rows=wk.pad_row, dim=16, walk_len=3, left_win=1, right_win=1,
        num_negs=2, table_mesh=tm,
        generator=torch.Generator().manual_seed(3)).to(mesh.device)
    negs = DeviceNodeSampler(g3, mesh=mesh)
    batch5 = {**b3, "sample_seed": 3, "nbr_table": wk.neighbors,
              "cum_table": wk.cum_weights, **negs.tables}
    out["walk"] = _loss(wk_model, batch5, mesh)
    _log(f"dryrun_multichip({n_devices}): device-walk step "
         f"loss={out['walk']:.4f} (walk tables {where})")

    # 6. the activation cache over the row-sharded tables, the cache
    # itself row-sharded; forward, backward and the cache write
    info = row_shard(store.features)
    rows = info.global_rows if info else int(store.features.shape[0])
    sc_model = DeviceSampledScalableSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=16, fanout=FANOUTS[0],
        num_layers=2, max_id=rows - 1, table_mesh=tm,
        generator=torch.Generator().manual_seed(6)).to(mesh.device)
    if shard:
        shard_caches(sc_model, mesh)
    out["act_cache"] = _loss(sc_model, batch3, mesh, train=True)
    h = sc_model.encoder.caches()[0].h
    touched = (h != 0).any(-1).sum().to(torch.int64)
    if shard:
        collectives.all_reduce(touched, mesh.group("model"))
    assert int(touched) > 0, "act-cache step never wrote the cache"
    note = (f"cache row-sharded {h.shape[0]}/{row_shard(h).global_rows} "
            "rows/rank" if shard else "cache replicated")
    _log(f"dryrun_multichip({n_devices}): act-cache step "
         f"loss={out['act_cache']:.4f} ({int(touched)} cache rows "
         f"written, {note}, tables {where})")
    out["act_cache_rows_written"] = float(touched)
    return out


def _spawned(rank: int, world: int, port: int, device) -> None:
    from euler_tpu_torch.parallel.multihost import (
        MultihostConfig, finalize_multihost, initialize_multihost,
    )

    initialize_multihost(MultihostConfig(f"127.0.0.1:{port}", world, rank,
                                         rank), device=device)
    try:
        dryrun_multichip(world, device=device)
    finally:
        finalize_multihost()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many local ranks (default: run as "
                         "one rank of a torchrun launch)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if args.nproc:
        import torch.multiprocessing as mp

        from euler_tpu_torch.parallel.multihost import free_port

        mp.spawn(_spawned, args=(args.nproc, free_port(), args.device),
                 nprocs=args.nproc)
        return 0
    from euler_tpu_torch.parallel.multihost import (
        finalize_multihost, initialize_multihost,
    )

    initialize_multihost(device=args.device)
    try:
        dryrun_multichip(int(os.environ.get("WORLD_SIZE", 1)),
                         device=args.device)
    finally:
        finalize_multihost()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
