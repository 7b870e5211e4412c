"""One run of a training cell, for the model families that train through
the estimator on a graph drawn from the seed (models/graphsage.py,
models/unsup_sage.py).

The run, in order:
1. set-up: the graph on the device from the seed; the family builds the
   program's tables, model and estimator from it; the benchmark's
   weights, made on the device from the seed, are loaded into the model;
   the feed (traffic/roots.py) goes through a prefetch thread of the
   cell's depth;
2. the warm-up: the estimator's own `train` runs the first K-step window
   (eager steps, then the capture of the K-step CUDA graph);
3. the checked replay: the seed's weights are copied back into the model
   and Adam's state is zeroed, both in place, so the captured graph
   trains from the seed again; one replay of the graph (`train` on the
   feed's next K batches) is the checked window. Its K losses, Adam's
   first moment after it and every parameter's change over it are read,
   and the roots and sampling seeds the replay read are kept;
4. the window: `train` on the feed until `seconds` have passed, closed
   on a whole replay and a synchronize; the same object goes on from the
   checked replay's state;
5. with --trace 1, a traced window of whole replays under torch.profiler,
   the sampler timed alone, and gather_mean's byte bound at the
   launches' rows;
6. the check: the model's own draw on the checked replay's inputs, and
   the program's gather_mean over its deepest hop; the program's state
   freed, the graph drawn again from the seed, the family's plain
   reference follows the K checked steps from the same weights: it
   holds the program's draws to its own exactly and the program's
   deepest means to its own plain-order means within one bfloat16
   ulp, then trains on those means, so that the order in which a
   kernel rounds them does not move the rest of the comparison; the
   numbers compared (numbers()) are held to the cell's limits.

The record it returns holds the host clocks, the estimator's phase
histograms, the counts and the trace's reduction; the readers under
metrics/ take the metrics from it.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gnnbench.traffic import products_like
from gnnbench.traffic.roots import Gate, RootFeed
from gnnbench.yardstick import counts
from gnnbench.yardstick import trace as tr

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
TINY_GRADIENT = 1e-3
SAMPLER_CALLS = 32


def derive_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for each input, from the run's seed."""
    words = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
        5, np.uint64)
    names = ("graph", "weights", "roots", "sample", "table")
    return {k: int(w) >> 1 for k, w in zip(names, words)}


def make_weights(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's float32 weights from the seed, on the device, in one
    draw for each kind. specs: (name, shape, kind); kind "lecun":
    truncated normal within two deviations, of variance 1/fan_in (flax's
    lecun_normal); "zeros"; ("uniform", s): U[0, s)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    lecun = [(n, s) for n, s, k in specs if k == "lecun"]
    total = sum(math.prod(s) for _, s in lecun)
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    # the truncation's standard deviation, flax's _TRUNC_STD
    trunc_std = 0.87962566103423978
    at = 0
    for name, shape in lecun:
        n = math.prod(shape)
        std = math.sqrt(1.0 / shape[-1]) / trunc_std
        out[name] = (z[at:at + n] * std).to(torch.float32).reshape(shape)
        at += n
    del u, z
    for name, shape, kind in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif isinstance(kind, tuple) and kind[0] == "uniform":
            out[name] = torch.rand(shape, generator=g, device=device) \
                * float(kind[1])
        elif kind != "lecun":
            raise ValueError(f"unknown weight kind {kind!r}")
    return out


def host_arrays(graph, num_classes: Optional[int] = None) -> dict:
    """The program's inputs as host arrays: the CSR, the float features
    with the pad row the feature store wants, and, given num_classes,
    the one-hot labels with it."""
    feats = torch.cat([graph.features,
                       graph.features.new_zeros(1, graph.features.shape[1])])
    out = {"offsets": graph.offsets.cpu().numpy(),
           "neighbors": graph.neighbors.cpu().numpy(),
           "features": feats.cpu().numpy()}
    if num_classes is not None:
        labels = torch.nn.functional.one_hot(graph.labels, num_classes)
        labels = torch.cat([labels, labels.new_zeros(1, num_classes)])
        out["labels"] = labels.to(torch.float32).cpu().numpy()
    return out


def encoder_specs(prefix: str, cfg: dict):
    """(specs, output width) of a mean-aggregator encoder's parameters,
    in the program's names: per depth a self and a neighbor transform,
    each a weight and a bias."""
    m = cfg["model"]
    dim, width, specs = int(m["dim"]), int(cfg["graph"]["feat_dim"]), []
    for depth in range(len(m["fanouts"])):
        for part in ("self", "nbr"):
            name = f"{prefix}.agg_{depth}.{part}"
            specs += [(name + ".weight", (dim, width), "lecun"),
                      (name + ".bias", (dim,), "zeros")]
        width = 2 * dim if m["concat"] else dim
    return specs, width


class SampledProgram:
    """The system under test, built from the benchmark's host arrays: the
    neighbor table and the int8 feature store from the port's
    engine-free constructors (`DeviceNeighborTable.from_csr`,
    `DeviceFeatureStore.from_arrays`, a bfloat16 scale), the family's
    further tables (node_tables) and its model in its estimator
    (estimator), each build timed to a synchronize."""

    def __init__(self, host: dict, cfg: dict, wl: dict, device,
                 table_seed: int):
        from euler_tpu_torch.parallel.device_sampler import (
            DeviceNeighborTable,
        )
        from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

        m = cfg["model"]
        self.device = device
        self.fanouts = tuple(int(k) for k in m["fanouts"])
        t = time.monotonic()
        self.table = DeviceNeighborTable.from_csr(
            host["offsets"], host["neighbors"], cap=int(m["neighbor_cap"]),
            seed=table_seed, device=device)
        _sync(device)
        self.neighbor_table_s = time.monotonic() - t
        self.store = DeviceFeatureStore.from_arrays(
            host["features"], host.get("labels"),
            quantize=m["feature_values"],
            scale_dtype=getattr(torch, m["feature_scale"]), device=device)
        self.node_tables(cfg)
        _sync(device)
        self.table_build_s = time.monotonic() - t
        t = time.monotonic()
        self.est = self.estimator(cfg, wl, {
            "learning_rate": float(cfg["optimizer"]["learning_rate"]),
            "optimizer": cfg["optimizer"]["name"],
            "log_steps": int(wl["log_steps"]),
            "checkpoint_steps": 0, "seed": 0,
            "steps_per_loop": int(wl["steps_per_loop"])})
        _sync(device)
        self.model_s = time.monotonic() - t
        self.feature_table = self.store.features
        self.feature_scale = self.store.feature_scale

    def node_tables(self, cfg: dict) -> None:
        """Further tables a family's model reads (none by default)."""

    def estimator(self, cfg: dict, wl: dict, params: dict):
        raise NotImplementedError

    def draw(self, batch: dict) -> List[torch.Tensor]:
        """The model's own draw for a batch: [roots, hop 1, hop 2, ...]."""
        raise NotImplementedError

    def batch(self, b: dict) -> dict:
        """A benchmark batch as the estimator's step takes it."""
        from euler_tpu_torch.platform import host_to_device

        return {"rows": [host_to_device(b["roots"], self.device)],
                "sample_seed": b["sample_seed"]}

    def deepest(self, picks) -> torch.Tensor:
        """The rows of the batch's gather_mean launch, [n, k] int32."""
        return picks[len(self.fanouts)].reshape(
            -1, self.fanouts[-1]).to(torch.int32)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> List[float]:
    """|prog - ref| / max(ref, the median leaf's ref) for each leaf: the
    gap between the two norms, never the norm of the difference."""
    med = statistics.median(ref.values())
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves] or [0.0]


def ulp_excess(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two bfloat16 tensors more than one representable
    step (one ulp) apart."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("the one-ulp comparison is of bfloat16 means")

    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int(((ordered(a) - ordered(b.to(a.device))).abs() > 1).sum())


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number the check can hold to a limit, from two observations
    of the checked window ({"losses", "moment", "dp"}; "picks_mismatch"
    and "mean_ulp_excess" on the program's side, "g1" on the
    reference's): the rows the program's side drew that differ from the
    reference's; its deepest means more than one bfloat16 ulp from the
    reference's; the loss gap, relative, at the first step and the
    widest over the steps; Adam's first moment after the window and
    each parameter's change over it, by the worst leaf, the change
    leaving out a leaf whose first reference gradient is nought to
    rounding. A cell holds those its limits name."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    med_g = statistics.median(ref["g1"].values())
    moving = [k for k, v in ref["g1"].items() if v >= TINY_GRADIENT * med_g]
    moment = _leaf_gaps(prog["moment"], ref["moment"], ref["moment"])
    change = _leaf_gaps(prog["dp"], ref["dp"], moving)
    return {
        "picks_mismatch": float(prog["picks_mismatch"]),
        "mean_ulp_excess": float(prog.get("mean_ulp_excess", 0)),
        "loss_gap_first": losses[0],
        "loss_gap": max(losses),
        "moment_gap": max(moment),
        "change_gap": max(change),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    limits: correct when each is finite and within its limit."""
    checks = {k: {"value": values[k], "limit": float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def count_mismatch(mine: List[torch.Tensor],
                   theirs: List[torch.Tensor]) -> int:
    """Rows that differ between two draws of one batch, a layer whose
    shape differs counting whole."""
    n = 0
    for a, b in zip(mine, theirs):
        if a.shape != b.shape:
            n += max(a.numel(), b.numel())
        else:
            n += int((a.long() != b.to(a.device).long()).sum())
    return n + sum(x.numel() for x in mine[len(theirs):]) \
        + sum(x.numel() for x in theirs[len(mine):])


def follow(ref, batches: List[dict], device, against=None, means=None,
           keep_picks: bool = False) -> dict:
    """The reference's steps over the checked batches, from where it
    stands: per-step losses, Adam's first moment and each parameter's
    change after the last step, the first gradient, the rows drawn that
    differ from `against` (per step, a list of rows each) and, given
    `means` (step → hop 2's means, the program's), the means more than
    one ulp from the reference's own, which the reference then trains
    on in place of its own."""
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    obs = {"losses": [], "picks": [], "picks_mismatch": 0,
           "mean_ulp_excess": 0}
    for t, b in enumerate(batches):
        batch = {"roots": torch.from_numpy(b["roots"]).to(device),
                 "sample_seed": b["sample_seed"]}
        given = means(t) if means is not None else None
        loss, grads, rows, own = ref.step(batch, means=given)
        obs["losses"].append(loss)
        if against is not None:
            obs["picks_mismatch"] += count_mismatch(rows, against[t])
        if given is not None:
            obs["mean_ulp_excess"] += ulp_excess(given, own)
        if keep_picks:
            obs["picks"].append([x.to(torch.int32) for x in rows])
        if t == 0:
            obs["g1"] = {k: float(g.double().norm())
                         for k, g in grads.items()}
        del grads, rows, own, given
    obs["moment"] = {k: float(m.double().norm())
                     for k, m in ref.adam.m.items()}
    obs["dp"] = {k: float((ref.params[k].detach() - p0[k]).double().norm())
                 for k in p0}
    return obs


def reference_runs(family, cfg: dict, seeds: Dict[str, int],
                   batches: List[dict], device, variants, against=None,
                   means=None, keep_picks: bool = False) -> List[dict]:
    """The family's plain reference over the checked batches, once for
    each (precision, fault) of `variants`, each from the benchmark's
    weights and a fresh Adam, on a graph drawn again from the seed and
    tables rebuilt once; each variant's rows compared with `against`,
    and each trained on `means` where given."""
    graph = products_like.generate(cfg["graph"], seeds["graph"], device)
    weights = make_weights(family.weight_specs(cfg), seeds["weights"],
                           device)
    ref = family.Reference(cfg, graph, seeds["table"], weights, device,
                           precision=variants[0][0], fault=variants[0][1])
    del graph
    out = []
    for i, (precision, fault) in enumerate(variants):
        if i:
            ref.start(weights, precision, fault)
        out.append(follow(ref, batches, device, against=against,
                          means=means, keep_picks=keep_picks))
    return out


def root_pool(graph, which: str) -> np.ndarray:
    """The rows a cell draws its roots from: "train", the training
    split; "all", every node."""
    if which == "train":
        return graph.train_rows.to(torch.int32).cpu().numpy()
    if which == "all":
        return np.arange(graph.num_nodes, dtype=np.int32)
    raise ValueError(f"unknown root pool {which!r}")


def _first_moment_norm(optimizer, p) -> float:
    """The norm of Adam's first moment of p; 0 where the optimizer holds
    none (it never stepped)."""
    m = optimizer.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.double().norm())


def restart(est, weights: Dict[str, torch.Tensor]) -> None:
    """The seed's weights copied into the model and Adam's state (its
    moments and step count) zeroed, all in place: the captured K-step
    graph reads them by address, so its next replay trains from the
    seed as a fresh estimator would."""
    est.model.load_state_dict(weights)
    with torch.no_grad():
        for state in est.optimizer.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()


def replay_batches(est, prog, kept: List[dict]) -> List[dict]:
    """The batches the last replay of the K-step graph read, as the
    model's own draw takes them: the roots from the graph's static
    inputs and each step's sampling generator seeded as the replay
    seeded it. Without a graph (on the CPU the estimator runs a window
    as K eager steps) the feed's kept batches."""
    g = getattr(est, "_graphed", None)
    inputs = getattr(g, "_inputs", None) or {}
    gens = getattr(g, "_sample_gens", None)
    if "rows" not in inputs or gens is None:
        return [prog.batch(b) for b in kept]
    out = []
    for i, gen in enumerate(gens):
        fresh = torch.Generator(device=est.device)
        fresh.manual_seed(gen.initial_seed())
        out.append({"rows": [x[i].clone() for x in inputs["rows"]],
                    "sample_generator": fresh})
    return out


def checked_replay(est, feeder, weights_fn, k: int) -> dict:
    """The checked window: the estimator restarted from the seed's
    weights, one K-step `train` window through the feed, and what it
    left: its K losses, Adam's first moment and each parameter's
    change."""
    weights = weights_fn()
    restart(est, weights)
    del weights
    losses = est.train(feeder, max_steps=est.step + k)["losses"]
    weights = weights_fn()
    named = dict(est.model.named_parameters())
    obs = {"losses": losses,
           "moment": {n: _first_moment_norm(est.optimizer, p)
                      for n, p in named.items()},
           "dp": {n: float((p.detach() - weights[n]).double().norm())
                  for n, p in named.items()}}
    del weights
    return obs


def program_means(prog, picks: List[List[torch.Tensor]]):
    """step → the program's gather_mean over the deepest hop of that
    step's picks: the kernel the replay launches, on the rows it read."""
    from euler_tpu_torch.ops.gather_mean import gather_mean

    table, scale = prog.feature_table, prog.feature_scale
    depth, k = len(prog.fanouts), prog.fanouts[-1]

    def means(t: int) -> torch.Tensor:
        rows = picks[t][depth].reshape(-1, k).to(torch.int32)
        return gather_mean(table, rows, scale)

    return means


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("" without it):
    a card set below its 700 W runs slower under load."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase_sums() -> Dict[str, float]:
    """The estimator's phase histograms' sums (ms), over every
    estimator of the process (a run builds one)."""
    from euler_tpu_torch import obs

    snap = obs.default_registry().snapshot(run_collectors=False)
    out = {}
    for name in ("estimator_input_wait_ms", "estimator_device_step_ms"):
        vals = snap.get(name, {}).get("values", {})
        out[name] = sum(v["sum"] for v in vals.values())
    return out


def _feeder(gate: Gate, prog, depth: int):
    from euler_tpu_torch.estimator.prefetch import make_feeder

    return make_feeder(gate, workers=0, depth=depth, transform=prog.batch)


def _traced_window(est, gate: Gate, prog, depth: int, windows: int,
                   k: int) -> dict:
    """`windows` + 1 whole replays through the feed under torch.profiler,
    read from the second replay's launch on: the union of the device's
    operations, the longest idle gaps, the top operations and
    gather_mean's mean time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    windows += 1
    gate.open(align=est.step, limit=windows * k)
    feeder = _feeder(gate, prog, depth)
    try:
        _sync(est.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("gnnbench.traced_window"):
                est.train(feeder, max_steps=est.step + windows * k)
                _sync(est.device)
    finally:
        feeder.close()
    dev, host = tr.split_events(prof.events())
    w0, w1 = next((s, e) for s, e, name in host
                  if name == "gnnbench.traced_window")
    # from the second replay's launch on: the first found the fresh
    # feed's queue and pinned buffers cold, as no replay of the window does
    launches = sorted(s for s, _, name in host if name == "cudaGraphLaunch")
    if len(launches) > 1:
        w0 = launches[1]
    host = [h for h in host if not h[2].startswith("gnnbench.")]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    return {"busy_s": tr.busy_seconds(dev), "window_s": (w1 - w0) / 1e6,
            "device_ops": tr.top_ops(dev),
            "idle_gaps": tr.idle_gaps(dev, host, (w0, w1)),
            "gather_mean_ms": tr.mean_kernel_ms(dev, "gather_mean")}


def _sampler_and_bound(prog, feed: RootFeed, peak) -> dict:
    """The model's own draw timed alone with CUDA events over
    SAMPLER_CALLS of the cell's batches, and gather_mean's byte bound at
    the rows those draws give its launches."""
    batches = [prog.batch(next(feed)) for _ in range(SAMPLER_CALLS)]
    prog.draw(batches[0])
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for b in batches:
        prog.draw(b)
    stop.record()
    stop.synchronize()
    out = {"sampler_ms_per_step": start.elapsed_time(stop) / len(batches)}
    if peak is not None:
        bounds = [counts.gather_mean_bound(
            prog.feature_table, prog.deepest(prog.draw(b)),
            prog.feature_scale, prog.feature_scale.dtype, peak)["bound_ms"]
            for b in batches[:8]]
        out["gather_mean_bound_ms"] = statistics.mean(bounds)
    return out


def check_cell(cfg: dict, wl: dict) -> None:
    """Refuse a cell whose stated precision or traffic this harness does
    not drive: it would run another cell under the cell's name."""
    if cfg["graph"].get("generator") != "products_like":
        raise ValueError(f"generator {cfg['graph'].get('generator')!r}: the "
                         "harness draws products_like graphs only")
    if cfg.get("precision") != "float32":
        raise ValueError(f"precision {cfg.get('precision')!r}: the harness "
                         "runs float32 (TF32 off) only")
    if wl.get("edge_weights") != "unit":
        raise ValueError(f"edge_weights {wl.get('edge_weights')!r}: the "
                         "harness draws unit edge weights only")


def program_picks(prog, batches: List[dict]) -> List[List[torch.Tensor]]:
    """The model's own draw on each batch, int32 rows."""
    return [[x.to(torch.int32) for x in prog.draw(b)] for b in batches]


def run(ctx, family) -> dict:
    """One run of a cell of `family` (a module of models/): the record
    the metric readers read, with correct / attempted / failed / device
    / checks, and every number the check computes with the seeds and
    batches it was read on."""
    cfg, wl = ctx.cfg, ctx.workload
    check_cell(cfg, wl)
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    seeds = derive_seeds(ctx.seed)
    k = int(wl["steps_per_loop"])
    depth = int(wl["prefetch_depth"])

    parts = {"start": time.monotonic() - ctx.process_start}
    t = time.monotonic()
    graph = products_like.generate(cfg["graph"], seeds["graph"], dev)
    _sync(dev)
    parts["graph"] = time.monotonic() - t
    t = time.monotonic()
    host = family.host_inputs(graph, cfg)
    pool = root_pool(graph, wl["roots"])
    del graph
    parts["host_arrays"] = time.monotonic() - t
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.monotonic()
    prog = family.Program(host, cfg, wl, dev, seeds["table"])
    del host
    parts["program"] = time.monotonic() - t
    parts["neighbor_table"] = prog.neighbor_table_s
    parts["tables"] = prog.table_build_s
    parts["model"] = prog.model_s
    t = time.monotonic()
    est = prog.est

    def weights():
        return make_weights(family.weight_specs(cfg), seeds["weights"], dev)

    est.model.load_state_dict(weights())
    _sync(dev)
    parts["weights"] = time.monotonic() - t
    # the first window trains on the feed's first K batches; the checked
    # replay on the next K
    feed = RootFeed(pool, int(wl["batch_size"]), seeds["roots"],
                    seeds["sample"], keep=(k, k))
    gate = Gate(feed, k)
    feeder = _feeder(gate, prog, depth)
    try:
        # the warm-up: the first window eager, then the capture
        _sync(dev)
        t = time.monotonic()
        est.train(feeder, max_steps=est.step + k)
        _sync(dev)
        capture_s = time.monotonic() - t
        parts["capture"] = capture_s
        t = time.monotonic()
        prog_obs = checked_replay(est, feeder, weights, k)
        checked = replay_batches(est, prog, feed.kept)
        _sync(dev)
        parts["checked_replay"] = time.monotonic() - t
        setup_s = time.monotonic() - ctx.process_start
        # the window
        sums0 = _phase_sums()
        skipped0, step0 = int(est.skipped_steps), est.step
        _sync(dev)
        t0 = time.monotonic()
        gate.open(align=step0, deadline=t0 + float(ctx.seconds))
        est.train(feeder, max_steps=1 << 62)
        _sync(dev)
        window_s = time.monotonic() - t0
    finally:
        feeder.close()
    steps = est.step - step0
    sums1 = _phase_sums()
    failed = int(est.skipped_steps) - skipped0
    peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = counts.peaks(kind)
    rec = {
        "setup_s": setup_s, "capture_s": capture_s,
        "table_build_s": prog.table_build_s,
        "window_s": window_s, "window_steps": steps,
        "roots_per_step": int(wl["batch_size"]),
        "input_wait_ms": sums1["estimator_input_wait_ms"]
        - sums0["estimator_input_wait_ms"],
        "dispatch_ms": sums1["estimator_device_step_ms"]
        - sums0["estimator_device_step_ms"],
        "model_flops_per_step": family.step_flops(cfg, wl),
        "peak": peak, "setup_parts": parts,
    }
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": peak_bytes}
    if ctx.trace and cuda:
        device["power_limit"] = _power_limit()
        t = _traced_window(est, gate, prog, depth,
                           int(wl["trace_windows"]), k)
        rec["trace"] = t
        rec.update(_sampler_and_bound(prog, feed, peak))
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        rec["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    picks = program_picks(prog, checked)
    means = program_means(prog, picks)
    del est, prog, feeder, gate, checked
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.monotonic()
    ref_obs = reference_runs(family, cfg, seeds, feed.kept, dev,
                             [("float32", None)], against=picks,
                             means=means)[0]
    del picks, means
    for key in ("picks_mismatch", "mean_ulp_excess"):
        prog_obs[key] = ref_obs[key]
    parts["reference_check"] = time.monotonic() - t
    values = numbers(prog_obs, ref_obs)
    correct, checks = judge(values, wl["limits"])
    rec.update(correct=correct, attempted=steps, failed=failed,
               device=device, checks=checks, numbers=values,
               seeds=seeds, kept=feed.kept)
    return rec
