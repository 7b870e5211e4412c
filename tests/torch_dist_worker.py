"""A gloo job of the port on the CPU for the multi-device tests: one
process per rank, each running every case of a job and saving its
arrays to <out_dir>/rank<r>.npz. Not a test module (pytest does not
collect it); tests/test_torch_parallel.py and test_torch_partition.py
spawn one job each through run_job and compare the ranks' arrays with
the reference run on a 4-device mesh of the 8 host devices.

The ranks import no JAX and nothing of the JAX package. Each runs with
OMP_NUM_THREADS=1 and imports euler_tpu_torch before torch (its
OMP_WAIT_POLICY=PASSIVE). The input makers below are plain numpy,
shared by the ranks and the tests.

    python tests/torch_dist_worker.py <job> <out_dir> <rank> <world> <port>
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


# -- inputs (numpy, seeded) --------------------------------------------------

def gather_inputs():
    rng = np.random.default_rng(0)
    tab = rng.normal(0, 1, (21, 5)).astype(np.float32)   # odd rows → pad
    rows = rng.integers(0, 21, 16).astype(np.int32)
    itab = rng.integers(0, 100, (21, 3)).astype(np.int32)
    feats = rng.normal(0, 3, (30, 6)).astype(np.float32)
    qrows = rng.integers(0, 30, 16).astype(np.int32)
    return tab, rows, itab, feats, qrows


def ring_inputs():
    rng = np.random.default_rng(3)
    table = rng.random((64, 16)).astype(np.float32)
    ids = rng.integers(0, 64, 40).astype(np.int32)
    rng = np.random.default_rng(5)
    table8 = rng.integers(-127, 128, (32, 8)).astype(np.int8)
    ids8 = rng.integers(0, 32, 16).astype(np.int32)
    return table, ids, table8, ids8


def emb_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, 24).astype(np.int32)
    table = (rng.random((64, 8)) * 0.05).astype(np.float32)
    return ids, table


SPMD = dict(num_classes=3, in_dim=6, dim=8, fanouts=(2, 2), max_id=31,
            id_dim=4, batch=8, lr=0.05)


def tiny_fanout_batch(batch, fanouts, feat_dim, num_classes, max_id, seed=0):
    """The reference's __graft_entry__._tiny_fanout_batch."""
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


def spmd_batches(n=3):
    c = SPMD
    return [tiny_fanout_batch(c["batch"], c["fanouts"], c["in_dim"],
                              c["num_classes"], c["max_id"], seed=s)
            for s in range(n)]


def steps_batches():
    """The 3 SPMD steps' batches: one batch 3 times, as the reference's
    test_spmd_graphsage_step_runs steps (its loss falls)."""
    return spmd_batches(1) * 3


def csr_graph(n=40, d=6, seed=7):
    """A weighted random graph as CSR (neighbors as rows, pad n), node
    features [n+1, d] (zero pad row), labels [n+1, 3] one-hot."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, n)
    deg[:3] = 0 if n > 3 else deg[:3]      # a few dead ends
    offs = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, int(offs[-1])).astype(np.int32)
    w = rng.integers(1, 4, int(offs[-1])).astype(np.float32)
    feats = np.zeros((n + 1, d), np.float32)
    feats[:n] = rng.normal(0, 1, (n, d))
    labels = np.zeros((n + 1, 3), np.float32)
    labels[np.arange(n), rng.integers(0, 3, n)] = 1.0
    return offs, nbrs, w, feats, labels


def skewed(n=96, d=8, seed=0):
    """The reference test_partition._skewed."""
    rng = np.random.default_rng(seed)
    degrees = np.maximum((rng.pareto(1.2, n) * 8).astype(np.int64), 1)
    feats = rng.normal(0, 1, (n + 1, d)).astype(np.float32)
    feats[-1] = 0.0
    return feats, degrees


# -- the launcher ------------------------------------------------------------

def run_job(job: str, out_dir: str, world: int = WORLD,
            timeout_s: float = 300.0) -> List[Dict[str, np.ndarray]]:
    """Spawn `world` ranks of `job`, wait, and return each rank's arrays.
    Raises with the ranks' logs when one fails or the job times out."""
    from euler_tpu_torch.core import lib
    from euler_tpu_torch.parallel.multihost import free_port

    # the ranks load the graph engine: build it once here, not in each
    lib.build()
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "OMP_WAIT_POLICY": "PASSIVE", "PYTHONWARNINGS": "ignore"}
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, out_dir,
             str(r), str(world), str(port)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad or "timeout"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = bad or None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        tails = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} ---\n" + f.read()[-4000:])
        raise RuntimeError(f"gloo job {job!r} failed ({failed}):\n"
                           + "\n".join(tails))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)]


# -- the ranks -----------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


class Rank:
    """What a case sees: its rank, the world, the inputs dir and the
    arrays it saves (`put`)."""

    def __init__(self, rank, world, out_dir):
        self.rank, self.world, self.out_dir = rank, world, out_dir
        self.out: Dict[str, np.ndarray] = {}

    def put(self, key, value):
        """Save a copy (a tensor's numpy view would follow later
        in-place updates)."""
        if hasattr(value, "detach"):
            value = _np(value)
        self.out[key] = np.array(value, copy=True)


def _global_loss(loss, mesh):
    from euler_tpu_torch.parallel import collectives

    loss = loss.detach().clone()
    if mesh.size("data") > 1:
        collectives.all_reduce(loss, mesh.group("data"))
    return loss


def job_parallel(ctx: Rank) -> None:
    import torch

    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.mesh import data_slice, make_mesh
    from euler_tpu_torch.parallel.device_sampler import make_table_gather
    from euler_tpu_torch.parallel.placement import put_row_sharded, row_shard

    A = make_mesh(2, device="cpu")        # {data: 2, model: 2}
    ctx.put("mesh_a", [A.size("data"), A.size("model"), A.index("data"),
                       A.index("model")])

    # the row-sharded gather: f32 (1-d and 2-d rows), int32, int8 + scale
    tab, rows, itab, feats, qrows = gather_inputs()
    g = make_table_gather(A)
    tab_s = put_row_sharded(tab, A)
    info = row_shard(tab_s)
    ctx.put("gather/shard", [info.lo, info.rows, info.global_rows])
    mine = data_slice({"r": rows}, A)["r"]
    ctx.put("gather/f32", g(tab_s, torch.from_numpy(mine)))
    ctx.put("gather/f32_2d", g(tab_s, torch.from_numpy(mine.reshape(2, -1))))
    ctx.put("gather/int32", g(put_row_sharded(itab, A),
                              torch.from_numpy(mine)))
    from euler_tpu_torch.models.graphsage import gather_feature_rows
    from euler_tpu_torch.parallel.feature_store import quantize_int8

    q, scale = quantize_int8(feats)
    qmine = data_slice({"r": qrows}, A)["r"]
    [deq] = gather_feature_rows(
        {"feature_table": put_row_sharded(q, A),
         "feature_scale": torch.from_numpy(scale)},
        [torch.from_numpy(qmine)], gather=g)
    ctx.put("gather/int8_deq", deq)
    ctx.put("gather/int8_raw", g(put_row_sharded(q, A),
                                 torch.from_numpy(qmine)))
    try:
        g(torch.zeros(17, 4), torch.zeros(4, dtype=torch.int32))
        ctx.put("gather/unpadded_refused", 0)
    except ValueError as e:
        ctx.put("gather/unpadded_refused", int("put_row_sharded" in str(e)))

    _spmd_cases(ctx, A)
    _device_model_cases(ctx, A)
    _act_cache_estimator(ctx, A)
    _data_axis_estimators(ctx, A)
    _replicated_estimators(ctx, A)
    _meshed_state(ctx, A)

    from euler_tpu_torch.parallel.dryrun import dryrun_multichip

    for k, v in dryrun_multichip(4, device="cpu").items():
        ctx.put(f"dryrun/{k}", v)
    collectives.reset_counts()


def _spmd_model():
    import torch

    from euler_tpu_torch.models.graphsage import ShardedSupervisedGraphSage

    c = SPMD
    return ShardedSupervisedGraphSage(
        c["num_classes"], c["in_dim"], multilabel=False, dim=c["dim"],
        fanouts=c["fanouts"], max_id=c["max_id"], id_dim=c["id_dim"],
        generator=torch.Generator().manual_seed(0))


def _spmd_cases(ctx: Rank, A) -> None:
    """3 Adam steps of the SPMD step; the shard gradient; the replicas;
    a NaN on one rank; sharded checkpoints both ways."""
    import torch

    from euler_tpu_torch.convert import gather_state_dict, shard_state_dict
    from euler_tpu_torch.parallel.mesh import shard_batch
    from euler_tpu_torch.parallel.train import (
        make_spmd_train_step, spmd_init,
    )
    from euler_tpu_torch.utils import optimizers as opt_lib

    tx = lambda ps: opt_lib.get("adam", ps, SPMD["lr"])  # noqa: E731
    batches = spmd_batches()
    model = _spmd_model()
    for k, v in model.state_dict().items():
        ctx.put(f"spmd/init/{k}", v)
    state = spmd_init(model, tx, A)
    ctx.put("spmd/shard_rows", model.id_emb.table.shape[0])
    # the shard's gradient of the global loss, no update
    grad_model = _spmd_model()
    spmd_init(grad_model, tx, A)
    grad_model.train()
    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.train import reduce_gradients

    with collectives.data_parallel(A):
        out = grad_model(shard_batch(batches[0], A))
    out.loss.backward()
    reduce_gradients(grad_model.parameters(), A)
    ctx.put("spmd/grad_table", grad_model.id_emb.table.grad)
    ctx.put("spmd/grad_out_w", grad_model.out.weight.grad)

    step = make_spmd_train_step(A)
    losses = []
    for b in steps_batches():
        state, loss, metric = step(state, shard_batch(b, A))
        losses.append(float(loss))
    ctx.put("spmd/losses", losses)
    full = gather_state_dict(model)
    for k, v in full.items():
        ctx.put(f"spmd/final/{k}", v)
    # replicas: every replicated parameter and its Adam moments, as held
    opt = state["optimizer"]
    for name, p in model.named_parameters():
        ctx.put(f"spmd/local/{name}", p)
        st = opt.state[p]
        for m in ("exp_avg", "exp_avg_sq"):
            ctx.put(f"spmd/local_{m}/{name}", st[m])

    # a NaN on rank 0's slice skips the step everywhere
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = shard_batch(batches[0], A)
    if ctx.rank == 0:
        bad["layers"][0] = bad["layers"][0].clone()
        bad["layers"][0][0, 0] = float("nan")
    state, loss, _ = step(state, bad)
    ctx.put("nan/skipped", int(state["skipped_steps"]))
    ctx.put("nan/unchanged", int(all(
        torch.equal(before[k], v) for k, v in model.state_dict().items())))

    # a whole (one-process) state into this rank's shards, and back
    ref = dict(np.load(os.path.join(ctx.out_dir, "inputs.npz")))
    from euler_tpu_torch.convert import flax_to_state_dict

    tree: Dict = {}
    for key, v in ref.items():
        node = tree
        *scope, leaf = key.split("/")
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = v
    whole = flax_to_state_dict(tree)
    m2 = _spmd_model()
    spmd_init(m2, tx, A)
    m2.load_state_dict(shard_state_dict(whole, m2))
    ctx.put("convert/in_shard", m2.id_emb.table)
    m2.eval()
    with collectives.data_parallel(A), torch.no_grad():
        out = m2(shard_batch(batches[0], A))
    ctx.put("convert/in_loss", _global_loss(out.loss, A))
    for k, v in gather_state_dict(m2).items():
        ctx.put(f"convert/out/{k}", v)


def _device_model_cases(ctx: Rank, A) -> None:
    """Each device-sampled model sharded ({data: 2, model: 2}, tables
    row-sharded) against the port's one-process run (replicated tables,
    the whole batch)."""
    import torch

    from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
    from euler_tpu_torch.models.graphsage import (
        DeviceSampledGraphSage, DeviceSampledLayerwiseGCN,
        DeviceSampledScalableSage, DeviceSampledUnsupervisedSage,
        shard_caches,
    )
    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.parallel.mesh import shard_batch
    from euler_tpu_torch.parallel.placement import row_shard

    offs, nbrs, w, feats, labels = csr_graph()
    n = len(offs) - 1
    roots = np.random.default_rng(1).integers(0, n, 8).astype(np.int32)

    def tables(sharded, fused=False):
        mesh = A if sharded else None
        kw = dict(mesh=mesh, shard_rows=sharded) if sharded else \
            dict(device="cpu")
        t = DeviceNeighborTable.from_csr(offs, nbrs, w, cap=4, fused=fused,
                                         **kw)
        s = DeviceFeatureStore.from_arrays(feats, labels, **kw)
        return {**t.tables, "feature_table": s.features,
                "label_table": s.labels}, t

    negs = DeviceNodeSampler.from_arrays(np.ones(n, np.float32),
                                         device="cpu")
    makers = {
        "split": lambda tm: DeviceSampledGraphSage(
            3, 6, multilabel=False, dim=8, fanouts=(3, 2), table_mesh=tm,
            generator=torch.Generator().manual_seed(2)),
        "unsup": lambda tm: DeviceSampledUnsupervisedSage(
            n, 6, dim=8, fanouts=(3, 2), num_negs=2, table_mesh=tm,
            generator=torch.Generator().manual_seed(3)),
        "walk": lambda tm: DeviceSampledSkipGram(
            n, dim=8, walk_len=3, left_win=1, right_win=1, num_negs=2,
            p=0.5, q=2.0, table_mesh=tm,
            generator=torch.Generator().manual_seed(4)),
        "layerwise": lambda tm: DeviceSampledLayerwiseGCN(
            3, 6, multilabel=False, dim=8, layer_sizes=(8, 8),
            table_mesh=tm, generator=torch.Generator().manual_seed(5)),
        "act_cache": lambda tm: DeviceSampledScalableSage(
            3, 6, multilabel=False, dim=8, fanout=3, num_layers=2,
            max_id=n, table_mesh=tm,
            generator=torch.Generator().manual_seed(6)),
    }
    makers["fused"] = makers["split"]

    def picks(name, model, batch):
        if name in ("split", "fused"):
            return model.sample_rows(batch)
        if name == "act_cache":
            return [model.sample_rows(batch)]
        if name == "unsup":
            rows, pos, ng = model.sample(batch)
            return [*rows, pos, ng]
        if name == "walk":
            return list(model.sample(batch))
        return model.sample_levels(batch)[0]

    # gather_mean's calls (its CPU path reaches gather_mean_reference): the
    # sharded paths must reach it nowhere, as the reference's sharded
    # reads reach no Pallas kernel
    from euler_tpu_torch.ops import gather_mean as gm

    plain, calls = gm.gather_mean_reference, [0]

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    gm.gather_mean_reference = counted
    for name, make in makers.items():
        fused = name == "fused"
        results = {}
        for sharded in (False, True):
            tabs, t = tables(sharded, fused)
            if name in ("unsup", "walk"):
                tabs = {**tabs, **negs.tables}
            model = make(A if sharded else None)
            train = name == "act_cache"
            model.train(train)
            if sharded and name == "act_cache":
                shard_caches(model, A)
            batch = {"rows": [torch.from_numpy(roots)], "sample_seed": 9}
            if sharded:
                batch = shard_batch(batch, A)
            batch.update(tabs)
            mesh = A if sharded else None
            with collectives.data_parallel(mesh):
                p = picks(name, model, batch)
                calls[0] = 0
                out = model(batch)
            ctx.put(f"models/{name}/{int(sharded)}/gather_mean_calls",
                    calls[0])
            if train:
                out.loss.backward()
            loss = _global_loss(out.loss, A) if sharded else out.loss
            results[sharded] = (p, loss, out.embedding)
            if name == "act_cache":
                h = model.encoder.caches()[0].h
                if sharded:
                    h = collectives.all_gather(
                        h.detach(), A.group("model"))[:row_shard(h).data_rows]
                ctx.put(f"models/{name}/{int(sharded)}/cache", h)
        for sharded, (p, loss, emb) in results.items():
            for i, x in enumerate(p):
                ctx.put(f"models/{name}/{int(sharded)}/pick{i}", x)
            ctx.put(f"models/{name}/{int(sharded)}/loss", loss)
            ctx.put(f"models/{name}/{int(sharded)}/emb", emb)
    gm.gather_mean_reference = plain
    # the reference's refusals under sharding
    try:
        DeviceSampledGraphSage(3, 6, remat=True, table_mesh=A)
        ctx.put("refuse/remat", 0)
    except ValueError as e:
        ctx.put("refuse/remat", int("replicated" in str(e)))
    try:
        DeviceNeighborTable.from_csr(offs, nbrs, w, cap=4, alias=True,
                                     mesh=A, shard_rows=True)
        ctx.put("refuse/alias", 0)
    except ValueError as e:
        ctx.put("refuse/alias", int("replicated" in str(e)))


def _act_cache_estimator(ctx: Rank, A) -> None:
    """The reference's test_act_cache_row_sharded through the port's
    NodeEstimator on the mesh."""
    import torch

    from euler_tpu_torch.dataset import engine_from_arrays
    from euler_tpu_torch.dataset.synthetic import synthetic_citation
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.graph import seed as engine_seed
    from euler_tpu_torch.models.graphsage import (
        DeviceSampledScalableSage, shard_act_cache,
    )
    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.parallel.memory_plan import plan_tables
    from euler_tpu_torch.parallel.placement import row_shard

    engine_seed(11)
    data = engine_from_arrays(synthetic_citation(
        n=200, d=16, num_classes=3, train_per_class=10, val=20, test=40,
        seed=11))
    g = data.engine
    store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                               label_dim=3, mesh=A, shard_rows=True)
    sampler = DeviceNeighborTable(g, cap=16, mesh=A, shard_rows=True)
    n_rows = row_shard(store.features).global_rows
    est = NodeEstimator(
        DeviceSampledScalableSage(3, 16, multilabel=False, dim=16, fanout=4,
                                  num_layers=2, max_id=n_rows - 1,
                                  table_mesh=A,
                                  generator=torch.Generator().manual_seed(0)),
        dict(batch_size=32, learning_rate=0.01, log_steps=1000,
             checkpoint_steps=0, train_node_type=-1),
        g, None, label_fid="label", label_dim=3, feature_store=store,
        device_sampler=sampler, mesh=A)
    try:
        shard_act_cache(est, A)
        ctx.put("est/early_refused", 0)
    except ValueError:
        ctx.put("est/early_refused", 1)
    res = est.train(est.train_input_fn(), max_steps=2)
    shard_act_cache(est, A)
    res = est.train(est.train_input_fn(), max_steps=8)
    h = est.model.encoder.caches()[0].h
    info = row_shard(h)
    ctx.put("est/cache_shard", [h.shape[0], info.global_rows])
    touched = (h != 0).any(-1).sum().to(torch.int64)
    collectives.all_reduce(touched, A.group("model"))
    ctx.put("est/touched", touched)
    p = plan_tables(n_rows - 1, cap=16, feat_dim=16, label_dim=0, mp=2,
                    quantize=None, feat_dtype_bytes=4, act_cache_dim=16,
                    act_cache_dtype_bytes=4, act_cache_sharded=True)
    ctx.put("est/plan_cache_bytes", [p["per_chip_table_bytes"]["act_cache"],
                                     h.numel() * h.element_size()])
    ctx.put("est/losses", res["losses"])
    ctx.put("est/step", est.step)
    _sharded_refresh(ctx, A, est, g, n_rows)


def _sharded_refresh(ctx: Rank, A, est, g, n_rows) -> None:
    """refresh_act_cache over the row-sharded caches (the table's pad
    row, global row live, lies past a rank's `per` rows) against the
    same state refreshed in one process: the caches gathered, and the
    gather_mean calls of each."""
    import torch

    from euler_tpu_torch.convert import gather_state_dict
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.models.graphsage import (
        DeviceSampledScalableSage, refresh_act_cache,
    )
    from euler_tpu_torch.ops import gather_mean as gm
    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.parallel.placement import row_shard

    one = NodeEstimator(
        DeviceSampledScalableSage(3, 16, multilabel=False, dim=16, fanout=4,
                                  num_layers=2, max_id=n_rows - 1),
        dict(batch_size=32, checkpoint_steps=0, train_node_type=-1),
        g, None, label_fid="label", label_dim=3,
        feature_store=DeviceFeatureStore(g, ["feature"], label_fid="label",
                                         label_dim=3, device="cpu"),
        device_sampler=DeviceNeighborTable(g, cap=16, device="cpu"),
        device="cpu")
    one.model.load_state_dict(gather_state_dict(est.model))
    ctx.put("refresh/live_per", [
        int(one.static_batch["feature_table"].shape[0]) - 1,
        est.model.encoder.caches()[0].h.shape[0]])
    plain, calls = gm.gather_mean_reference, [0]

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    gm.gather_mean_reference = counted
    try:
        for tag, e in (("mesh", est), ("one", one)):
            calls[0] = 0
            refresh_act_cache(e, chunk=64)
            ctx.put(f"refresh/{tag}/gather_mean_calls", calls[0])
    finally:
        gm.gather_mean_reference = plain
    h = est.model.encoder.caches()[0].h
    ctx.put("refresh/mesh/cache", collectives.all_gather(
        h.detach(), A.group("model"))[:row_shard(h).data_rows])
    ctx.put("refresh/one/cache", one.model.encoder.caches()[0].h)


def data_axis_batches(n, seed0):
    """n global batches of SPMD's shape, each with a metric_mask whose
    two data halves count different rows (a mean of the halves' means
    is not the batch's)."""
    c = SPMD
    out = []
    for s in range(n):
        b = tiny_fanout_batch(c["batch"], c["fanouts"], c["in_dim"],
                              c["num_classes"], c["max_id"], seed=seed0 + s)
        mask = np.ones(c["batch"], np.float32)
        mask[c["batch"] // 2 + 1:] = 0.0
        b["metric_mask"] = np.roll(mask, s)
        out.append(b)
    return out


def skipgram_batches(n, max_id=31, negs=3, b=8, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = rng.integers(0, max_id + 1, b).astype(np.uint64)
        out.append({"src": src, "ids": src, "infer_ids": src,
                    "pos": rng.integers(0, max_id + 1, b).astype(np.uint64),
                    "negs": rng.integers(0, max_id + 1, (b, negs))
                    .astype(np.uint64)})
    return out


def unsup_sage_batches(n, seed, b=8, fanouts=(2, 2), d=6, max_id=31,
                       negs=3):
    """n host-fed UnsupervisedGraphSage batches: the roots' fanout
    features, their contexts (pos [B]) and negatives [B, negs]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sizes = [b]
        for k in fanouts:
            sizes.append(sizes[-1] * k)
        src = rng.integers(0, max_id + 1, b).astype(np.uint64)
        out.append({
            "layers": [rng.normal(0, 1, (s, d)).astype(np.float32)
                       for s in sizes],
            "src": src, "infer_ids": src,
            "pos": rng.integers(0, max_id + 1, b).astype(np.uint64),
            "negs": rng.integers(0, max_id + 1, (b, negs)).astype(np.uint64)})
    return out


def _estimator_runs(ctx: Rank, A, prefix: str, build, train, evals) -> None:
    """An estimator built by build(mesh or device kwargs) on the mesh
    and in one process, fed the same global batches one step at a time:
    each step's loss and metric, evaluate()'s, and the whole
    parameters after the steps."""
    from euler_tpu_torch.convert import gather_state_dict

    for meshed in (0, 1):
        est = build(dict(mesh=A) if meshed else dict(device="cpu"))
        steps = []
        for i, b in enumerate(train):
            r = est.train(iter([b]), max_steps=i + 1)
            steps.append([r["loss"], r["metric"]])
        ev = est.evaluate(iter(evals), steps=len(evals))
        ctx.put(f"{prefix}/{meshed}/steps", steps)
        ctx.put(f"{prefix}/{meshed}/eval", [ev["loss"], ev["metric"]])
        for k, v in gather_state_dict(est.model).items():
            ctx.put(f"{prefix}/{meshed}/param/{k}", v)


def _data_axis_estimators(ctx: Rank, A) -> None:
    """The estimators of models that split over the data axis, on
    {data: 2, model: 2} against themselves in one process
    (_estimator_runs): NodeEstimator with ShardedSupervisedGraphSage and
    SupervisedGraphSage, EdgeEstimator with DeepWalk, LINE and the
    host-fed UnsupervisedGraphSage. A batch array whose rows the data
    axis does not divide raises, through the estimator and in
    data_slice."""
    import torch

    from euler_tpu_torch.estimator.estimators import (
        EdgeEstimator, NodeEstimator,
    )
    from euler_tpu_torch.models.embedding_models import LINE, DeepWalk
    from euler_tpu_torch.models.graphsage import (
        ShardedSupervisedGraphSage, SupervisedGraphSage,
        UnsupervisedGraphSage,
    )
    from euler_tpu_torch.parallel.mesh import data_slice

    c = SPMD
    cfg = dict(batch_size=c["batch"], learning_rate=c["lr"],
               optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
               train_node_type=-1, seed=0)
    makers = {
        "sharded": (NodeEstimator, lambda: ShardedSupervisedGraphSage(
            c["num_classes"], c["in_dim"], multilabel=False, dim=c["dim"],
            fanouts=c["fanouts"], max_id=c["max_id"], id_dim=c["id_dim"],
            generator=torch.Generator().manual_seed(0)),
            data_axis_batches(3, 10), data_axis_batches(2, 20)),
        "sage": (NodeEstimator, lambda: SupervisedGraphSage(
            c["num_classes"], c["in_dim"], multilabel=True, dim=c["dim"],
            fanouts=c["fanouts"],
            generator=torch.Generator().manual_seed(1)),
            data_axis_batches(3, 30), data_axis_batches(2, 40)),
        "deepwalk": (EdgeEstimator, lambda: DeepWalk(
            c["max_id"], dim=c["dim"],
            generator=torch.Generator().manual_seed(2)),
            skipgram_batches(3), skipgram_batches(2, seed=6)),
        "line": (EdgeEstimator, lambda: LINE(
            c["max_id"], dim=c["dim"],
            generator=torch.Generator().manual_seed(3)),
            skipgram_batches(3, seed=7), skipgram_batches(2, seed=8)),
        "unsup_sage": (EdgeEstimator, lambda: UnsupervisedGraphSage(
            c["in_dim"], c["dim"], c["max_id"], fanouts=c["fanouts"],
            num_negs=3, generator=torch.Generator().manual_seed(4)),
            unsup_sage_batches(3, 9), unsup_sage_batches(2, 10)),
    }
    for name, (cls, make, train, evals) in makers.items():
        _estimator_runs(
            ctx, A, f"dax/{name}",
            lambda kw: cls(make(), cfg, None, None, **kw), train, evals)

    raised = []
    est = NodeEstimator(makers["sage"][1](), cfg, None, None, mesh=A)
    seven = tiny_fanout_batch(7, c["fanouts"], c["in_dim"],
                              c["num_classes"], c["max_id"])
    for fn in (lambda: est.train(iter([seven]), max_steps=1),
               lambda: data_slice({"x": np.zeros(5)}, A)):
        try:
            fn()
            raised.append(0)
        except ValueError as e:
            raised.append(int("does not divide" in str(e)))
    ctx.put("dax/indivisible", raised)


def _citation(seed=11):
    """A 200-node synthetic citation graph in the port's engine, the
    engine's draws seeded."""
    from euler_tpu_torch.dataset import engine_from_arrays
    from euler_tpu_torch.dataset.synthetic import synthetic_citation
    from euler_tpu_torch.graph import seed as engine_seed

    engine_seed(seed)
    return engine_from_arrays(synthetic_citation(
        n=200, d=16, num_classes=3, train_per_class=10, val=20, test=40,
        seed=seed))


def small_graphs(n=12, d=4, seed=3):
    """n random small graphs {x, edge_index} and their binary labels."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        k = int(rng.integers(3, 7))
        e = int(rng.integers(k, 2 * k))
        graphs.append({"x": rng.normal(0, 1, (k, d)).astype(np.float32),
                       "edge_index": rng.integers(0, k, (2, e))
                       .astype(np.int32)})
    return graphs, rng.integers(0, 2, n)


def _replicated_estimators(ctx: Rank, A) -> None:
    """The models that do not split over the data axis on {data: 2,
    model: 2}: every data rank takes the whole batch, so each equals its
    one-process run bit for bit (_estimator_runs): BaseEstimator with
    TransE, SuperviseSolution and DGI, GaeEstimator with the GAE,
    GraphEstimator with GraphModel, and NodeEstimator with the
    full-batch gcn ConvModel. The batches are drawn once and fed to
    both runs."""
    import itertools

    import torch

    from euler_tpu_torch.estimator.base_estimator import (
        BaseEstimator, _to_device,
    )
    from euler_tpu_torch.estimator.estimators import (
        GaeEstimator, GraphEstimator, NodeEstimator,
    )
    from euler_tpu_torch.examples.common import ConvModel
    from euler_tpu_torch.examples.run_gae import FlowAdapter
    from euler_tpu_torch.dataflow import FullBatchDataFlow
    from euler_tpu_torch.models.dgi import DGI
    from euler_tpu_torch.models.kg_models import TransE
    from euler_tpu_torch.mp_utils.base_gae import BaseGraphGAE
    from euler_tpu_torch.mp_utils.graph_gnn import GraphModel
    from euler_tpu_torch.solution.base_solution import SuperviseSolution

    cfg = dict(learning_rate=0.05, log_steps=1 << 30, checkpoint_steps=0,
               seed=0)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    take = lambda it, n: list(itertools.islice(it, n))  # noqa: E731
    runs = {}

    rng = np.random.default_rng(12)
    triples = [{"h": rng.integers(0, 20, 8), "r": rng.integers(0, 4, 8)
                .astype(np.int32), "t": rng.integers(0, 20, 8),
                "neg_t": rng.integers(0, 20, (8, 3))} for _ in range(5)]
    runs["transe"] = (lambda kw: BaseEstimator(
        TransE(20, 4, dim=6, generator=gen(0)), cfg, **kw), triples)

    data = _citation(13)
    g = data.engine
    sol = lambda: SuperviseSolution(  # noqa: E731
        g, fanouts=(3, 2), dim=8, num_classes=3, batch_size=8,
        generator=gen(1))
    runs["solution"] = (lambda kw: BaseEstimator(sol().model, cfg, **kw),
                        take(sol().input_fn(), 5))

    flow = FullBatchDataFlow(g, feature_ids=["feature"])
    gae_cfg = dict(cfg, batch_size=8, num_pos=12)
    gae = lambda kw: GaeEstimator(  # noqa: E731
        BaseGraphGAE(16, dim=4, generator=gen(2)), gae_cfg, g,
        FlowAdapter(flow), **kw)
    runs["gae"] = (gae, take(gae(dict(device="cpu")).train_input_fn(), 5))

    full = flow(g.all_node_ids())
    perm = np.random.default_rng(14)

    def dgi(kw):
        est = BaseEstimator(DGI(16, dim=6, generator=gen(3)), cfg, **kw)
        est.static_batch.update(_to_device(full, est.device))
        return est

    runs["dgi"] = (dgi, [{"x_corrupt": full["x"][perm.permutation(
        full["x"].shape[0])]} for _ in range(5)])

    graphs, labels = small_graphs()
    graph = lambda kw: GraphEstimator(  # noqa: E731
        GraphModel(4, "gin", "sum", dim=8, num_graphs=4, generator=gen(4)),
        dict(cfg, num_graphs=4, seed=5), graphs, labels, **kw)
    one = graph(dict(device="cpu"))
    runs["graph"] = (graph, take(one.train_input_fn(), 3)
                     + take(one.eval_input_fn(), 2))

    conv = lambda kw: NodeEstimator(  # noqa: E731
        ConvModel(3, 16, "gcn", dim=8, generator=gen(6)),
        dict(cfg, batch_size=8), g, flow, label_fid="label", label_dim=3,
        **kw)
    one = conv(dict(device="cpu"))
    runs["conv_gcn"] = (conv, take(one.train_input_fn(), 3)
                        + take(one.eval_input_fn(), 2))

    for name, (build, batches) in runs.items():
        _estimator_runs(ctx, A, f"rep/{name}", build, batches[:3],
                        batches[3:])


def _meshed_state(ctx: Rank, A) -> None:
    """What a meshed NodeEstimator(ShardedSupervisedGraphSage) writes,
    against the same estimator in one process on the same batches:
    checkpoint_steps=1's files in a model_dir every rank shares (the
    listing after each step, the last file's model and optimizer
    state), the meshed checkpoint restored in one process and a
    one-process checkpoint restored on the mesh (the whole parameters
    after one more step), and infer's and export_bundle's files."""
    import torch

    from euler_tpu_torch.convert import gather_state_dict
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.serving.export import ModelBundle

    c = SPMD
    cfg = dict(batch_size=c["batch"], learning_rate=c["lr"],
               optimizer="adam", log_steps=1 << 30, train_node_type=-1,
               seed=0)
    root = os.path.join(ctx.out_dir, "state")
    mesh_dir = os.path.join(root, "mesh")
    one_dir = os.path.join(root, f"one_rank{ctx.rank}")

    def est(meshed, model_dir, ckpt):
        kw = dict(mesh=A) if meshed else dict(device="cpu")
        return NodeEstimator(_spmd_model(), {**cfg, "checkpoint_steps": ckpt},
                             None, None, model_dir=model_dir, **kw)

    def ckpt_file(d, step):
        return torch.load(os.path.join(d, "checkpoints", f"ckpt-{step}.pt"),
                          map_location="cpu", weights_only=True)

    train = data_axis_batches(4, 50)
    m, o = est(True, mesh_dir, 1), est(False, one_dir, 1)
    listing = []
    for i, b in enumerate(train[:3]):
        m.train(iter([b]), max_steps=i + 1)
        o.train(iter([b]), max_steps=i + 1)
        listing.append(",".join(sorted(os.listdir(
            os.path.join(mesh_dir, "checkpoints")))))
    for tag, d in (("mesh", mesh_dir), ("one", one_dir)):
        p = ckpt_file(d, 3)
        ctx.put(f"ckpt/{tag}/step", [p["step"], p["skipped_steps"]])
        for k, v in p["model"].items():
            ctx.put(f"ckpt/{tag}/model/{k}", v)
        for i, st in p["optimizer"]["state"].items():
            for k, v in st.items():
                ctx.put(f"ckpt/{tag}/opt/{i}/{k}", v)
    # each way before the writer's next step: the meshed file into one
    # process, the one-process file onto the mesh
    o2, m2 = est(False, mesh_dir, 0), est(True, one_dir, 0)
    for e in (o2, m2, m, o):
        e.train(iter([train[3]]), max_steps=4)
    listing.append(",".join(sorted(os.listdir(
        os.path.join(mesh_dir, "checkpoints")))))
    ctx.put("ckpt/listing", np.array(listing))
    ctx.put("ckpt/restored_steps", [o2.step, m2.step])
    for tag, e in (("mesh", m), ("one", o), ("mesh_in_one", o2),
                   ("one_on_mesh", m2)):
        for k, v in gather_state_dict(e.model).items():
            ctx.put(f"ckpt/after/{tag}/{k}", v)

    # infer and export: the meshed files against the one-process ones
    infer = data_axis_batches(2, 70)
    for s, b in enumerate(infer):
        b["infer_ids"] = np.arange(100 + 8 * s, 108 + 8 * s,
                                   dtype=np.uint64)[::-1].copy()
    for tag, e in (("mesh", m), ("one", o)):
        paths = e.infer(iter(infer), steps=len(infer))
        ctx.put(f"infer/{tag}/emb", np.load(paths["embedding"]))
        ctx.put(f"infer/{tag}/ids", np.load(paths["ids"]))
        out = os.path.join(e.model_dir, "bundle")
        got = e.export_bundle(out, input_fn=lambda: iter(infer),
                              index=False)
        disk = ModelBundle.load(out)
        ctx.put(f"export/{tag}/same_as_returned", int(
            np.array_equal(disk.ids, got.ids)
            and np.array_equal(disk.embeddings, got.embeddings)))
        ctx.put(f"export/{tag}/ids", disk.ids)
        ctx.put(f"export/{tag}/emb", disk.embeddings)
        for k, v in disk.params.items():
            ctx.put(f"export/{tag}/param/{k.replace(chr(39), '')}", v)


def job_partition(ctx: Rank) -> None:
    import torch

    from euler_tpu_torch.parallel.mesh import make_mesh
    from euler_tpu_torch.parallel.partitioned_store import (
        PartitionedFeatureStore, hub_routed_take,
    )
    from euler_tpu_torch.parallel.placement import put_row_sharded
    from euler_tpu_torch.parallel.ring_exchange import (
        allgather_lookup, ring_lookup,
    )

    M = make_mesh(4, device="cpu")           # {data: 1, model: 4}
    me = M.index("model")

    # the exchanges: values and gradients, f32 and int8
    table, ids, table8, ids8 = ring_inputs()
    for name, fn in (("ring", ring_lookup), ("allgather", allgather_lookup)):
        shard = put_row_sharded(table, M).requires_grad_(True)
        n = len(ids) // 4
        out = fn(shard, torch.from_numpy(ids[me * n:(me + 1) * n]), M)
        (out ** 2).sum().backward()
        ctx.put(f"x/{name}/out", out)
        ctx.put(f"x/{name}/grad", shard.grad)
        n8 = len(ids8) // 4
        ctx.put(f"x/{name}/int8", fn(
            put_row_sharded(table8, M),
            torch.from_numpy(ids8[me * n8:(me + 1) * n8]), M))

    # ShardedEmbedding's three lookups on {1, 4} and {2, 2}
    from euler_tpu_torch.parallel import collectives
    from euler_tpu_torch.parallel.sharded_embedding import (
        ShardedEmbedding, apply_param_shardings,
    )

    e_ids, e_table = emb_inputs()
    A = make_mesh(2, device="cpu")
    for tag, mesh in (("m4", M), ("m2", A)):
        for mode in ("gspmd", "ring", "allgather"):
            m = ShardedEmbedding(64, 8, lookup=mode)
            m.table.data = torch.from_numpy(e_table.copy())
            apply_param_shardings(m, mesh)
            from euler_tpu_torch.parallel.mesh import data_slice

            mine = data_slice({"i": e_ids}, mesh)["i"]
            with collectives.data_parallel(mesh):
                out = m(torch.from_numpy(mine))
                from euler_tpu_torch.utils.metrics import masked_mean

                loss = masked_mean((out ** 2).sum(-1), None)
            loss.backward()
            from euler_tpu_torch.parallel.train import reduce_gradients

            reduce_gradients(m.parameters(), mesh)
            ctx.put(f"emb/{tag}/{mode}/out", out)
            ctx.put(f"emb/{tag}/{mode}/grad", m.table.grad)
    # a whole table's row-sparse gradient (utils/layers.Embedding on a
    # card) summed over the data axis of {2, 2}: made dense first
    import torch.nn.functional as F

    from euler_tpu_torch.parallel.mesh import data_slice
    from euler_tpu_torch.parallel.train import reduce_gradients
    from euler_tpu_torch.utils.metrics import masked_mean

    t = torch.nn.Parameter(torch.from_numpy(e_table.copy()))
    mine = data_slice({"i": e_ids}, A)["i"]
    with collectives.data_parallel(A):
        out = F.embedding(torch.from_numpy(mine).long(), t, sparse=True)
        loss = masked_mean((out ** 2).sum(-1), None)
    loss.backward()
    ctx.put("emb/row_sparse/was_sparse", int(t.grad.is_sparse))
    reduce_gradients([t], A)
    ctx.put("emb/row_sparse/grad", t.grad)
    m = ShardedEmbedding(63, 4, lookup="ring")
    apply_param_shardings(m, M)
    try:
        m(torch.arange(8))
        ctx.put("emb/guard", 0)
    except ValueError as e:
        ctx.put("emb/guard", int("divisible" in str(e)))

    # the partitioned store
    for strategy in ("allgather", "ring", "psum"):
        for hub in (0.0, 0.05):
            feats, degrees = skewed()
            st = PartitionedFeatureStore.from_arrays(
                feats, degrees, mesh=M, hub_cache_frac=hub)
            rows = np.random.default_rng(7).integers(
                0, st.pad_row + 1, 53).astype(np.int32)
            ctx.put(f"p/f32/{strategy}/{hub}",
                    st.make_gather(strategy)(torch.from_numpy(rows)))
        feats, degrees = skewed(seed=1)
        st = PartitionedFeatureStore.from_arrays(
            feats, degrees, mesh=M, hub_cache_frac=0.05, quantize="int8")
        rows = np.random.default_rng(11).integers(
            0, st.pad_row + 1, 40).astype(np.int32)
        ctx.put(f"p/int8/{strategy}",
                st.make_gather(strategy)(torch.from_numpy(rows)))
    feats, degrees = skewed(seed=2)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.02)
    ctx.put("p/auto", st.make_gather("auto")(
        torch.arange(st.pad_row + 1, dtype=torch.int32)))
    # hub rows never reach the cold leg
    feats, degrees = skewed(seed=3)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.1)
    rows = np.random.default_rng(13).integers(
        0, st.pad_row + 1, 256).astype(np.int32)
    seen = []
    full = torch.from_numpy(st.apply_permutation(feats))

    def spy(table, cold):
        seen.append(cold.clone())
        return table[cold.long()]

    ctx.put("hub/out", hub_routed_take(spy, st.hub_cache)(
        full, torch.from_numpy(rows)))
    ctx.put("hub/cold", seen[0])
    ctx.put("hub/route", [st.route_batch(rows)[k]
                          for k in ("rows", "cached", "local", "remote")])
    # counters and the health view
    from euler_tpu_torch import obs

    feats, degrees = skewed(seed=4)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.1,
        name=f"ptable_rank{ctx.rank}")
    st.observe_batch(np.arange(st.pad_row, dtype=np.int32))
    cs = st.cache_stats()
    ctx.put("ctr/stats", [cs["hub_hits"], cs["hub_misses"],
                          cs["gather_rows"]["local"],
                          cs["gather_rows"]["remote"],
                          cs["gather_rows"]["cached"], cs["per_chip_bytes"],
                          st.hub_size, st.pad_row])
    ctx.put("ctr/hub_mass", st.hub_mass)
    snap = obs.health_snapshot()
    reg = obs.default_registry().snapshot()
    ctx.put("ctr/health", [
        snap[f"ptable_rank{ctx.rank}"]["hub_size"],
        reg["table_hbm_bytes"]["values"][f"store=ptable_rank{ctx.rank}"]])
    obs.unregister_health(f"ptable_rank{ctx.rank}")
    # make_table_gather(hub_cache=...) on both branches, 2-d rows
    from euler_tpu_torch.parallel.device_sampler import make_table_gather

    feats, degrees = skewed(n=64, d=8, seed=8)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.1)
    full = st.apply_permutation(feats)
    rows2d = np.random.default_rng(17).integers(
        0, st.pad_row + 1, (6, 8)).astype(np.int32)
    ctx.put("mtg/rep", make_table_gather(None, hub_cache=st.hub_cache)(
        torch.from_numpy(full), torch.from_numpy(rows2d)))
    ctx.put("mtg/sharded", make_table_gather(M, hub_cache=st.hub_cache)(
        put_row_sharded(full, M), torch.from_numpy(rows2d)))
    ctx.put("mtg/want", full[rows2d])
    _partition_training(ctx, M)


def _partition_training(ctx: Rank, M) -> None:
    import torch

    from euler_tpu_torch.parallel.partitioned_store import (
        PartitionedFeatureStore,
    )

    # make_spmd_train_step(table_store=...) counts the dispatched rows
    from euler_tpu_torch.parallel.train import (
        make_spmd_train_step, spmd_init,
    )
    from euler_tpu_torch.utils import optimizers as opt_lib
    from euler_tpu_torch.utils.layers import Dense
    from euler_tpu_torch.mp_utils.base import ModelOutput

    feats, degrees = skewed(n=64, d=8, seed=9)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.1)
    ftab = torch.from_numpy(feats)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.d = Dense(8, 1, generator=torch.Generator().manual_seed(0))

        def forward(self, batch):
            out = self.d(ftab[batch["rows"].long()])
            return ModelOutput(out, (out ** 2).mean(), "m", out.mean())

    state = spmd_init(Toy(), lambda ps: opt_lib.get("sgd", ps, 0.1), M)
    step = make_spmd_train_step(M, table_store=st)
    rows = torch.from_numpy(np.asarray(np.random.default_rng(5).integers(
        0, 64, 16), np.int32))
    before = st.cache_stats()["gather_rows"]
    state, loss, _ = step(state, {"rows": rows})
    state, loss, _ = step(state, {"rows": rows})
    after = st.cache_stats()["gather_rows"]
    ctx.put("store_step/counted", sum(after[k] - before[k]
                                      for k in ("local", "cached",
                                                "remote")))
    ctx.put("store_step/loss", loss)

    # the loss trajectory over partitioned gathers equals the replicated
    feats, degrees = skewed(n=64, d=8, seed=6)
    st = PartitionedFeatureStore.from_arrays(
        feats, degrees, mesh=M, hub_cache_frac=0.1)
    full = torch.from_numpy(st.apply_permutation(feats))
    gather = st.make_gather("allgather")
    rng = np.random.default_rng(31)
    rs = [rng.integers(0, st.pad_row, 16).astype(np.int32) for _ in range(6)]
    ys = [rng.normal(0, 1, (16, 1)).astype(np.float32) for _ in range(6)]

    def run(feature_fn):
        head = Dense(8, 1, generator=torch.Generator().manual_seed(0))
        opt = opt_lib.get("sgd", head.parameters(), 0.1)
        losses = []
        for r, y in zip(rs, ys):
            x = feature_fn(torch.from_numpy(r))
            loss = ((head(x) - torch.from_numpy(y)) ** 2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss))
        return losses

    ctx.put("traj/base", run(lambda r: full[r.long()]))
    ctx.put("traj/part", run(gather))

    _partition_estimator(ctx, M)
    _engine_store(ctx, M)
    _cluster_spmd(ctx)


def _engine_graph(n=40, d=4):
    """The reference test_partition._engine_graph, in the port's engine."""
    from euler_tpu_torch.graph import GraphBuilder, seed

    seed(7)
    b = GraphBuilder()
    b.set_num_types(1, 1)
    b.set_feature(0, 0, d, "feature")
    ids = np.arange(1, n + 1, dtype=np.uint64)
    b.add_nodes(ids)
    rng = np.random.default_rng(9)
    src = rng.integers(1, n + 1, n * 6).astype(np.uint64)
    dst = (rng.random(n * 6) ** 3 * n).astype(np.uint64) + 1
    b.add_edges(src, dst, weights=np.ones(n * 6, np.float32))
    b.set_node_dense(ids, 0, rng.normal(0, 1, (n, d)).astype(np.float32))
    return b.finalize(), ids


def _partition_estimator(ctx: Rank, M) -> None:
    """NodeEstimator over the partitioned + hub-cached store (host
    fanout rows) against a replicated store, step for step; the
    table_partition options train."""
    import torch

    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.graph import seed as engine_seed
    from euler_tpu_torch.models.graphsage import SupervisedGraphSage
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
    from euler_tpu_torch.parallel.partitioned_store import (
        PartitionedFeatureStore,
    )

    g, ids = _engine_graph(n=48)

    def run(store, mesh, cfg):
        engine_seed(99)
        flow = FanoutDataFlow(g, [3, 2], with_features=False)
        model = SupervisedGraphSage(4, 4, multilabel=True, dim=8,
                                    fanouts=(3, 2),
                                    generator=torch.Generator().manual_seed(0))
        est = NodeEstimator(
            model, dict(batch_size=8, learning_rate=0.05, optimizer="sgd",
                        log_steps=1 << 30, checkpoint_steps=0,
                        train_node_type=-1, seed=0, **cfg),
            g, flow, label_fid="feature", label_dim=4, feature_store=store,
            mesh=mesh, device=None if mesh is not None else "cpu")
        rng = np.random.default_rng(21)
        losses = []
        for step in range(1, 7):
            roots = rng.choice(ids, 8, replace=False)
            batch = est._node_batch(roots, flow)
            losses.append(est.train(iter([batch]), max_steps=step)["loss"])
        return est, losses

    _, base = run(DeviceFeatureStore(g, ["feature"], device="cpu"), None, {})
    est, part = run(PartitionedFeatureStore(g, ["feature"], mesh=M,
                                            hub_cache_frac=0.1), M,
                    {"table_partition": 4, "hub_cache_frac": 0.1})
    ctx.put("est/base", base)
    ctx.put("est/part", part)
    stats = est.health()["feature_store"]
    ctx.put("est/counted", sum(stats["gather_rows"][k]
                               for k in ("local", "cached", "remote")))
    ctx.put("est/hub", [stats["hub_size"], est.feature_store.hub_size,
                        int("hub_cache" in est.static_batch)])


def _engine_store(ctx: Rank, M) -> None:
    import torch

    from euler_tpu_torch.parallel.partitioned_store import (
        PartitionedFeatureStore,
    )

    g, ids = _engine_graph()
    st = PartitionedFeatureStore(g, ["feature"], mesh=M, hub_cache_frac=0.1)
    probe = np.concatenate([ids[:7], [np.uint64(10_000)]])
    ctx.put("eng/lookup", st.make_gather("allgather")(
        torch.from_numpy(st.lookup(probe))))
    n = len(ids)
    st = PartitionedFeatureStore(g, ["feature"], mesh=M, hub_cache_frac=0.1,
                                 device_rows=n // 2)
    rows, host = st.lookup_with_overflow(ids)
    try:
        st.lookup(ids)
        ctx.put("eng/refused", 0)
    except ValueError as e:
        ctx.put("eng/refused", int("host-overflow" in str(e)))
    got = st.fetch_host_rows(ids[host])
    st.fetch_host_rows(ids[host])
    ctx.put("eng/host_rows", got)
    ctx.put("eng/host_mask", host)
    ctx.put("eng/host_counts", [st.host_rows,
                                st._host_engine.cache_stats()["hits"],
                                st.cache_stats()["gather_rows"]["host"]])
    ctx.put("eng/dev_rows", st.make_gather("ring")(
        torch.from_numpy(rows[~host])))


def _cluster_spmd(ctx: Rank) -> None:
    """The reference's test_cluster_feeds_spmd_training: batches from a
    2-shard graph service (served by rank 0, broadcast) drive the SPMD
    step on {data: 2, model: 2}; the loss falls over 8 steps."""
    import torch
    import torch.distributed as dist

    from euler_tpu_torch.models.graphsage import ShardedSupervisedGraphSage
    from euler_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from euler_tpu_torch.parallel.train import (
        make_spmd_train_step, spmd_init,
    )
    from euler_tpu_torch.utils import optimizers as opt_lib

    batches = [None]
    if ctx.rank == 0:
        batches = [_cluster_batches(8)]
    dist.broadcast_object_list(batches, src=0)
    A = make_mesh(2, device="cpu")
    model = ShardedSupervisedGraphSage(
        4, 8, multilabel=False, dim=16, fanouts=(3, 2), max_id=63,
        id_dim=8, generator=torch.Generator().manual_seed(0))
    state = spmd_init(model, lambda ps: opt_lib.get("adam", ps, 5e-2), A)
    step = make_spmd_train_step(A)
    losses = []
    for b in batches[0]:
        state, loss, _ = step(state, shard_batch(b, A))
        losses.append(float(loss))
    ctx.put("cluster/losses", losses)


def _cluster_batches(n_batches: int):
    import tempfile

    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.gql import start_service
    from euler_tpu_torch.graph import GraphBuilder, RemoteGraphEngine, seed

    seed(7)
    b = GraphBuilder()
    b.set_num_types(2, 1)
    b.set_feature(0, 0, 8, "feature")
    b.set_feature(1, 0, 4, "label")
    ids = np.arange(1, 41, dtype=np.uint64)
    b.add_nodes(ids, types=(ids % 2).astype(np.int32),
                weights=np.ones(40, dtype=np.float32))
    src = np.concatenate([ids, ids])
    dst = np.concatenate([np.roll(ids, -1), np.roll(ids, -3)])
    b.add_edges(src, dst, types=np.zeros(80, np.int32),
                weights=np.ones(80, np.float32))
    rng = np.random.default_rng(0)
    cls = (ids % 4).astype(np.int64)
    feats = rng.normal(0, 1, (40, 8)).astype(np.float32)
    feats[np.arange(40), cls] += 2.0
    b.set_node_dense(ids, 0, feats)
    b.set_node_dense(ids, 1, np.eye(4, dtype=np.float32)[cls])
    g = b.finalize()
    data_dir = tempfile.mkdtemp(prefix="etg_cluster_")
    g.dump(data_dir, num_partitions=2)
    servers = [start_service(data_dir, shard_idx=i, shard_num=2, port=0)
               for i in range(2)]
    eps = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    remote = RemoteGraphEngine(f"hosts:{eps}", seed=3)
    try:
        flow = FanoutDataFlow(remote, [3, 2], feature_ids=["feature"])
        out = []
        for _ in range(n_batches):
            roots = remote.sample_node(16, 0)
            fb = flow(roots)
            out.append({
                "ids": [(i.astype(np.int64) % 64).astype(np.int32)
                        for i in fb["ids"]],
                "layers": fb["layers"],
                "labels": remote.get_dense_feature(roots, "label")})
        return out
    finally:
        remote.close()
        for s in servers:
            s.stop()


JOBS = {"parallel": job_parallel, "partition": job_partition}


def main(argv) -> int:
    job, out_dir, rank, world, port = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import euler_tpu_torch  # noqa: F401  (before torch: OMP passive)
    from euler_tpu_torch.parallel.multihost import (
        MultihostConfig, finalize_multihost, initialize_multihost,
    )

    initialize_multihost(MultihostConfig(f"127.0.0.1:{port}", world, rank),
                         device="cpu")
    ctx = Rank(rank, world, out_dir)
    try:
        JOBS[job](ctx)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **ctx.out)
    finalize_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
