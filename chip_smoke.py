#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (euler_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH] [--baseline-source PATH]
                          [--extra-loop-k K ...]

The GraphSAGE path at the width of bench.py's flagship configuration
(bench.py:776-869): a products-like graph (2.45M nodes, average degree
50, 16 classes, 100-dim features quantized to int8 with a bfloat16
per-column scale, neighbor cap 32), DeviceSampledGraphSage with dim 128
and fanouts [15, 10] and random seeded weights, root batches of 32768.
Phases, in order; any failure raises and the exit code is not 0:

  1. device   the card's name and power limit (nvidia-smi); TF32 off
  2. build    nvcc builds every kernel under euler_tpu_torch/csrc; ptxas
              registers and spills per kernel (a spill fails the run)
  3. graph    synthetic graph → feature store + neighbor table on the card
  4. kernels  gather_mean against its plain version at the path's shapes
              (int8 + bf16 scale, int8 + f32 scale, f32 table), the cora
              runner's (n 640, D 1433, int8 + f32 scale) and the path's
              int8 table one byte off alignment; per case its launch
              plan, time, GB/s and share of the bound, the plain
              version's time, embedding_bag's and the bound; a sweep of
              launch plans on the main case
  5. slice    the inference sweep over every node (75 batches) through
              the kernel (launch count checked), finite outputs, kernel
              forward vs plain forward
  6. train    NodeEstimator.train with Adam (lr 0.01) on the same
              tables: 5 warm-up steps, 30 timed steps in 3 windows
              (bench.py:883-911), then 10 event-timed steps; edges/s,
              one profiled step, launches == steps, a finite falling
              loss, no skipped step; one remat=True step against the
              plain step (same loss, gradients, 2 launches)
  7. loop     the same training at steps_per_loop = 32 (bench.py's K,
              bench.py:41-44), fed by bench.py's prefetch thread (depth
              3): K + 2 warm-up steps (the first window eager, then the
              capture of the 32-step CUDA graph, then a tail of 2), 3
              timed windows of 64 steps (two replays each); edges/s,
              host ms per step, ms per replay (events), busy share from
              one profiled replay (32 gather_mean kernels in it), peak
              memory, and launches: eager launches + launches recorded
              per window x replays == steps. Then the graph against
              eager steps at the same shapes: 3 windows of 32 from the
              same weights and batches at K = 32 and at K = 1 give the
              same losses, parameters and Adam moments, bit for bit
  8. quality  the port's GraphSAGE runner (fit_citation, --int8_features)
              on the cora stand-in for seeds 0, 1, 2: mean test
              micro-F1 at least 0.79 (the RESULTS.md row is 0.811)
  9. small    a small input through the card and through the CPU path
 10. serve    embed / score requests against direct indexing
 11. result   the kernels JSON line, then {"ok": true, "device": ...}

Without CUDA it exits 1 and prints no result. --out PATH also writes
the full record (every case, timing and profile) as JSON.
--extra-loop-k K also times phase 7's loop at steps_per_loop = K.
--baseline-source PATH builds an earlier gather_mean.cu that has the
first kernel's C entry (gather_mean_launch without plan arguments) and
times it against the current kernel in phase 4, in turns (old, new,
new, old) on every case.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from euler_tpu_torch.dataset.synthetic import products_like, synthetic_citation
from euler_tpu_torch.estimator.estimators import NodeEstimator
from euler_tpu_torch.estimator.infer import NodeInferencer
from euler_tpu_torch.estimator.prefetch import make_feeder
from euler_tpu_torch.examples import run_graphsage
from euler_tpu_torch.kernels import _build
from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
from euler_tpu_torch.ops import gather_mean as gather_mean_module
from euler_tpu_torch.ops.gather_mean import (
    gather_mean, gather_mean_reference, launch_plan, take_rows,
)
from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore
from euler_tpu_torch.serving.engine import EmbeddingEngine

FULL_NODES = 2_450_000
AVG_DEGREE, FEAT_DIM, NUM_CLASSES, CAP = 50, 100, 16, 32
DIM, FANOUTS, BATCH = 128, (15, 10), 32768
# H100 SXM published peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TIMED_SAMPLES, BURST = 20, 5
# training (bench.py:776-911): Adam at lr 0.01, 5 warm-up steps, 30
# timed steps in 3 windows; then event-timed steps
TRAIN_LR, WARMUP_STEPS, TIMED_STEPS, WINDOWS, EVENT_STEPS = 0.01, 5, 30, 3, 10
EDGES_PER_STEP = sum(BATCH * int(np.prod(FANOUTS[:h + 1]))
                     for h in range(len(FANOUTS)))
# the K-step loop (bench.py:41-44, :622-657, :857-899): K = 32, the
# prefetch thread's depth 3, K + 2 warm-up steps, 3 timed windows
LOOP_K, FEEDER_DEPTH, LOOP_WINDOW_STEPS, LOOP_EQ_WINDOWS = 32, 3, 64, 3
# quality: RESULTS.md graphsage-dev-int8 | cora | micro-F1 | 0.811
QUALITY_SEEDS, QUALITY_FLOOR, QUALITY_ROW, QUALITY_BAND = (0, 1, 2), 0.79, \
    0.811, 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def query_card() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median over TIMED_SAMPLES of CUDA-event time per call, each sample
    a burst of BURST back-to-back calls (so host overhead overlaps the
    device work), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMED_SAMPLES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BURST):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / BURST)
    return statistics.median(samples)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def gather_mean_bound(table, rows, scale, out_dtype) -> dict:
    """Least time for the work: each distinct table row this run reads,
    the indices and the scale read once, the output written once; the
    adds and multiplies at the float32 rate."""
    n, k = rows.shape
    d = table.shape[1]
    distinct = int(torch.unique(rows).numel())
    nbytes = (rows.numel() * rows.element_size()
              + distinct * d * table.element_size()
              + (scale.numel() * scale.element_size() if scale is not None
                 else 0)
              + n * d * torch.tensor([], dtype=out_dtype).element_size())
    ops = n * k * d + 2 * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "distinct_rows": distinct}


def phase_device() -> dict:
    card = query_card()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: torch %s cuda %s numpy %s, %s x%d; matmul.allow_tf32=%s "
        "cudnn.allow_tf32=%s" % (
            torch.__version__, torch.version.cuda, np.__version__,
            torch.cuda.get_device_name(0), torch.cuda.device_count(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
    return {"nvidia_smi": card, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "numpy": np.__version__}


def ptxas_report(nvcc_log: str) -> list:
    """[(kernel, registers, spill bytes)] from nvcc's -Xptxas -v output,
    kernel names demangled where c++filt exists."""
    rows, name, spill = [], None, 0
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r[0] = re.sub(r"^void |\(.*", "", n)
    return [tuple(r) for r in rows]


def start_baseline_build(src: str) -> tuple:
    """nvcc for an earlier gather_mean.cu, started now (it runs beside
    the current kernel's build); wait with finish_baseline_build."""
    out = _build.BUILD_DIR / "baseline" / "gather_mean.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_baseline_build(proc, out):
    import ctypes

    log_text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline gather_mean build failed:\n{log_text}")
    fn = ctypes.CDLL(str(out)).gather_mean_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def baseline_gather_mean(fn, table, rows, scale, out=None):
    """The earlier kernel on the same inputs (its dtype codes are the
    current ones), into `out` when given; not counted in
    gather_mean.launches."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    n, k = rows.shape
    if out is None:
        out = torch.empty(
            (n, table.shape[1]),
            dtype=scale.dtype if scale is not None else table.dtype,
            device=table.device)
    rc = fn(table.data_ptr(), codes[table.dtype], rows.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            codes[scale.dtype] if scale is not None else -1, out.data_ptr(),
            n, k, table.shape[1], table.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline gather_mean launch failed: {rc}")
    return out


def phase_build(baseline_source=None) -> tuple:
    base = (start_baseline_build(baseline_source) if baseline_source
            else None)
    r = _build.build("gather_mean")
    log(f"build: gather_mean {r['seconds']:.1f}s")
    report = ptxas_report(r["log"])
    for name, regs, spill in report:
        log(f"  ptxas {name}: {regs} registers, {spill} bytes spilled")
    spilled = [x for x in report if x[2] > 0]
    if not report:
        raise AssertionError("no ptxas report for gather_mean (remove its "
                             "library under build/ to rebuild it)")
    if spilled:
        raise AssertionError(f"ptxas spilled registers: {spilled}")
    t0 = time.monotonic()
    base_fn = finish_baseline_build(*base) if base else None
    if base:
        log(f"build: baseline gather_mean ({baseline_source}) ready "
            f"{time.monotonic() - t0:.1f}s after the current one")
    return {"gather_mean_seconds": r["seconds"], "ptxas": report}, base_fn


def phase_graph(dev: torch.device):
    t0 = time.monotonic()
    g = products_like(FULL_NODES, AVG_DEGREE, FEAT_DIM, NUM_CLASSES)
    t_graph = time.monotonic() - t0
    t0 = time.monotonic()
    feats = np.concatenate([g.features, np.zeros((1, FEAT_DIM), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, NUM_CLASSES), np.float32)])
    store = DeviceFeatureStore.from_arrays(
        feats, labels, quantize="int8", scale_dtype=torch.bfloat16,
        device=dev)
    del feats, labels
    table = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=CAP,
                                         device=dev)
    t_tables = time.monotonic() - t0
    edges = int(g.neighbors.size)
    node_types = g.node_types
    del g
    log(f"graph: {FULL_NODES} nodes, {edges} directed edges, built in "
        f"{t_graph:.1f}s; tables in {t_tables:.1f}s (uniform_rows="
        f"{table.uniform_rows}, hub_frac={table.hub_frac:.3f}, "
        f"edge_keep_frac={table.edge_keep_frac:.3f})")
    return store, table, node_types, {
                          "nodes": FULL_NODES, "directed_edges": edges,
                          "graph_seconds": t_graph,
                          "table_seconds": t_tables,
                          "uniform_rows": table.uniform_rows,
                          "hub_frac": table.hub_frac,
                          "edge_keep_frac": table.edge_keep_frac}


def cora_case(dev: torch.device) -> tuple:
    """The cora runner's gather_mean shapes (run_graphsage.py defaults:
    batch 64, fanouts [10, 10], so n = 640 hop-1 rows with k = 10 over a
    [2709, 1433] int8 table with a float32 scale), seeded data."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-127, 128, (2709, 1433),
                                      dtype=np.int8)).to(dev)
    scale = torch.from_numpy(rng.random(1433, dtype=np.float32)
                             / 127).to(dev)
    rows = torch.from_numpy(rng.integers(0, 2708, (640, 10),
                                         dtype=np.int32)).to(dev)
    return q, scale, rows


def payload_bytes(table, rows, out_dtype) -> int:
    """What the kernel moves as it gathers: every (row, neighbor) row
    read whole, the indices, the output (the bound counts distinct rows
    instead)."""
    n, k = rows.shape
    d = table.shape[1]
    return (n * k * d * table.element_size() + rows.numel() * 4
            + n * d * torch.tensor([], dtype=out_dtype).element_size())


def phase_kernels(store, rows: torch.Tensor, dev: torch.device,
                  baseline=None) -> dict:
    """gather_mean vs its plain version on the path's own deepest-hop
    rows [n, k] and feature table, the cora runner's shapes and the
    path's table one byte off alignment. Tolerances: float32 outputs
    within 1e-5 of the largest value (summation order and the 1/k and
    scale multiplies); bfloat16 outputs within 2^-7 of the largest (one
    bf16 rounding). With a baseline kernel, old and new are timed in
    turns (old, new, new, old) on every case."""
    q, scale_bf16 = store.features, store.feature_scale
    scale_f32 = scale_bf16.float()
    table_f32 = q.float() * scale_f32
    shifted = torch.empty(q.numel() + 1, dtype=torch.int8, device=dev)
    shifted[1:] = q.view(-1)
    shifted = shifted[1:].view(q.shape)
    cq, cscale, crows = cora_case(dev)
    cases = [
        ("int8+bf16 scale", q, scale_bf16, rows,
         lambda: q.to(torch.bfloat16) * scale_bf16),
        ("int8+f32 scale", q, scale_f32, rows, lambda: table_f32),
        ("f32 table", table_f32, None, rows, lambda: table_f32),
        ("cora int8+f32 scale", cq, cscale, crows,
         lambda: cq.float() * cscale),
        ("int8+bf16 scale, table 1 byte off", shifted, scale_bf16, rows,
         lambda: q.to(torch.bfloat16) * scale_bf16),
    ]
    results = []
    for name, table, scale, r_, dense_fn in cases:
        got = gather_mean(table, r_, scale)
        torch.cuda.synchronize()
        ref = gather_mean_reference(table, r_, scale)
        err = max_abs_err(got, ref)
        big = float(ref.float().abs().max())
        tol = (2 ** -7 if got.dtype == torch.bfloat16 else 1e-5) * big
        if not (err <= tol) or got.dtype != ref.dtype \
                or got.shape != ref.shape:
            raise AssertionError(f"gather_mean {name}: max abs err {err} "
                                 f"> tol {tol} (or dtype/shape mismatch)")
        plan = launch_plan(table, r_, got, scale)
        dense = dense_fn()

        def launch_only():  # the kernel without the wrapper's host work
            gather_mean_module._launch(table, r_, scale, got, plan)
        r = {"case": name, "n": r_.shape[0], "k": r_.shape[1],
             "D": table.shape[1], "N": table.shape[0],
             "max_abs_err": err, "tol": tol, "plan": plan._asdict(),
             "ms": time_ms(lambda: gather_mean(table, r_, scale)),
             "launch_only_ms": time_ms(launch_only),
             "plain_ms": time_ms(
                 lambda: gather_mean_reference(table, r_, scale)),
             "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
                 r_, dense, mode="mean"))}
        del dense
        r.update(gather_mean_bound(table, r_, scale, got.dtype))
        r["payload_bytes"] = payload_bytes(table, r_, got.dtype)
        r["payload_gbps"] = r["payload_bytes"] / r["ms"] / 1e6
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if baseline is not None:
            old = baseline_gather_mean(baseline, table, r_, scale)
            torch.cuda.synchronize()
            r["baseline_max_abs_err_vs_new"] = max_abs_err(old, got)
            if not r["baseline_max_abs_err_vs_new"] <= tol:
                raise AssertionError(f"baseline kernel disagrees on {name}")
            turns = []  # both through a thin ctypes call into one buffer
            for which in ("old", "new", "new", "old"):
                fn = ((lambda: baseline_gather_mean(baseline, table, r_,
                                                    scale, old))
                      if which == "old" else launch_only)
                turns.append((which, time_ms(fn)))
            r["turns_ms"] = turns
            log(f"  turns old/new/new/old: "
                + " / ".join(f"{t:.4f}" for _, t in turns) + " ms")
        log(f"kernel gather_mean [{name}] n={r['n']} k={r['k']} D={r['D']} "
            f"N={r['N']} plan V={plan.vec_bytes} lanes={plan.lanes} "
            f"rows/block={plan.rows_per_block} grid={plan.grid}x"
            f"{plan.col_blocks}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g}); kernel_ms {r['ms']:.4f} (launch "
            f"only {r['launch_only_ms']:.4f}) "
            f"({r['payload_gbps']:.1f} GB/s payload, {r['bound_share']:.1%} "
            f"of the bound) plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']})")
        results.append(r)
        del got, ref
    del shifted
    return {"cases": results, "plans": plan_sweep(q, scale_bf16, rows)}


def plan_sweep(table, scale, rows) -> list:
    """The main case at 4, 8 and 16 warps per block (launch_plan's
    default is 4). Informational."""
    out = torch.empty((rows.shape[0], table.shape[1]), dtype=scale.dtype,
                      device=table.device)
    res = []
    for rpb in (4, 8, 16):
        plan = launch_plan(table, rows, out, scale, rows_per_block=rpb)
        ms = time_ms(lambda: gather_mean_module._launch(
            table, rows, scale, out, plan))
        res.append({"plan": plan._asdict(), "ms": ms})
        log(f"  plan rows/block={rpb} grid={plan.grid}x{plan.col_blocks}: "
            f"{ms:.4f} ms")
    return res


def _check_finite(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not torch.isfinite(t).all():
        raise AssertionError(f"{name}: non-finite values")


def phase_slice(inf: NodeInferencer, model) -> dict:
    """The embedding export: embed_all over every node of the store."""
    inf.run(next(inf.infer_input_fn(inf.store.ids[:BATCH])))  # warm-up
    torch.cuda.synchronize()
    gather_mean.launches = 0
    t0 = time.monotonic()
    sweep = list(inf.infer_input_fn())
    t_batches = time.monotonic() - t0
    out_ids, emb = inf.embed_all(sweep)
    wall = time.monotonic() - t0
    launches = gather_mean.launches
    if launches != len(sweep):
        raise AssertionError(f"gather_mean launched {launches} times for "
                             f"{len(sweep)} forwards")
    if not np.array_equal(out_ids, inf.store.ids):
        raise AssertionError("embed_all returned the wrong ids")
    n_roots = len(out_ids)
    if emb.shape != (n_roots, 2 * DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"embeddings: shape {emb.shape} or non-finite")
    per_fwd = []
    for b in sweep:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        inf.run(b)
        stop.record()
        stop.synchronize()
        per_fwd.append(start.elapsed_time(stop))
    # kernel forward vs the same rows through the plain neighbor mean
    batch = {**sweep[0], **inf.static_batch}
    with torch.inference_mode():
        out = model(batch)
        logits = model.out(out.embedding)
        _check_finite("logits", logits, (BATCH, NUM_CLASSES))
        if not (torch.isfinite(out.loss) and torch.isfinite(out.metric)):
            raise AssertionError("non-finite loss or metric")
        rows = model.sample_rows(batch)
        table, scale = batch["feature_table"], batch["feature_scale"]
        emb_k = model.encoder(table, scale, rows)
        emb_p = model.encoder(table, scale, rows,
                              neighbor_mean=gather_mean_reference)
        logit_err = max_abs_err(model.out(emb_k), model.out(emb_p))
    fwd_err = max_abs_err(emb_k, emb_p)
    fwd_tol = 2 ** -7 * float(emb_p.abs().max())
    if not fwd_err <= fwd_tol:
        raise AssertionError(f"kernel forward vs plain forward: {fwd_err} "
                             f"> {fwd_tol}")
    edges = EDGES_PER_STEP
    ms = statistics.median(per_fwd)
    t_fwd = sum(per_fwd) / 1e3
    r = {"forwards": len(sweep), "roots": n_roots,
         "gather_mean_launches": launches, "sweep_seconds": wall,
         "batch_build_seconds": t_batches,
         "forward_seconds": t_fwd,
         "host_rest_seconds": wall - t_batches - t_fwd,
         "device_busy_share": t_fwd / wall,
         "roots_per_s": n_roots / wall,
         "edges_per_forward": edges,
         "edges_per_s": edges * len(sweep) / wall,
         "forward_ms": per_fwd, "forward_ms_median": ms,
         "device_edges_per_s": edges / (ms / 1e3),
         "kernel_vs_plain_forward_err": fwd_err,
         "kernel_vs_plain_forward_tol": fwd_tol,
         "kernel_vs_plain_logit_err": logit_err,
         "loss_batch0": float(out.loss), "metric_batch0": float(out.metric),
         "profile": profile_device(lambda: inf.run(sweep[1]),
                                   "one forward")}
    log(f"slice: {len(sweep)} forwards of {BATCH} roots over {n_roots} "
        f"nodes (fanouts {list(FANOUTS)}, dim {DIM}), gather_mean launches "
        f"{launches}; sweep {wall:.3f}s = {r['roots_per_s']:.0f} roots/s, "
        f"{r['edges_per_s']:.4g} edges/s; forward_ms median {ms:.3f} "
        f"(events) = {r['device_edges_per_s']:.4g} edges/s; kernel vs "
        f"plain forward err {fwd_err:.3g} (tol {fwd_tol:.3g}); sweep "
        f"split: batches {t_batches:.3f}s, forwards {t_fwd:.3f}s (events, "
        f"{r['device_busy_share']:.1%} of the sweep), host copies + dedup "
        f"{r['host_rest_seconds']:.3f}s")
    return r, out_ids, emb


def profile_device(fn, what: str, top_n: int = 10) -> dict:
    """One call of fn under torch.profiler: device time by kernel, and
    by kind (gather_mean, GEMMs, the rest). Informational: a profiler
    that records no device time is reported, not failed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    # device-side kernels only: an aten op's self device time repeats
    # the time of the kernels it launched, and a record_function range
    # (e.g. Optimizer.step) shows on the device as an annotation
    rows = sorted(((dev_us(e), e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and dev_us(e) > 0), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    top = [{"name": k[:90], "ms": us / 1e3, "calls": c}
           for us, k, c in rows[:top_n]]
    # masked_fill runs on the path only in take_rows (the fill rule of
    # the hop-0/1 gathers); its index compares count as "other"
    kinds = {"gather_mean": 0.0, "gemm": 0.0, "masked_fill": 0.0,
             "other": 0.0}
    for us, k, _ in rows:
        kind = ("gather_mean" if "gather_mean" in k
                else "gemm" if "gemm" in k.lower()
                else "masked_fill" if "masked_fill" in k else "other")
        kinds[kind] += us / 1e3
    log(f"profile: {what}, wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms over {len(rows)} kernel names; gather_mean "
        f"{kinds['gather_mean']:.3f} ms, GEMMs {kinds['gemm']:.3f} ms, "
        f"take_rows' masked fills {kinds['masked_fill']:.3f} ms, the rest "
        f"{kinds['other']:.3f} ms")
    for t in top:
        log(f"  {t['ms']:8.3f} ms  x{t['calls']:<3d} {t['name']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top": top,
            "by_kind_ms": kinds,
            "gather_mean_calls": sum(c for _, k, c in rows
                                     if "gather_mean" in k)}


def phase_train(store, table, node_types, dev: torch.device) -> dict:
    """Train the flagship model through NodeEstimator on the sweep's
    tables, as bench.py times it: warm-up, then 3 windows of steps on
    the host clock with a synchronize at the window edges only."""
    est = flagship_estimator(store, table, node_types, dev)
    model = est.model
    it = est.train_input_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_mean.launches = 0
    losses = est.train(it, max_steps=WARMUP_STEPS)["losses"]
    per_window = TIMED_STEPS // WINDOWS
    window_s, window_rates = [], []
    sums0 = _phase_sums(est)
    for _ in range(WINDOWS):
        done = est.step
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=done + per_window)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        window_s.append(dt)
        window_rates.append((res["global_step"] - done) / dt)
        losses += res["losses"]
    timed_s = sum(window_s)
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    # device time per step: CUDA events around the step itself, batches
    # built beforehand; and the host's time to enqueue the step
    batches = [next(it) for _ in range(EVENT_STEPS)]
    step_ms, host_ms, event_losses = [], [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loss, _ = est._train_step(b)
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        event_losses.append(loss)
        step_ms.append(start.elapsed_time(stop))
    losses += torch.stack(event_losses).cpu().tolist()
    peak = torch.cuda.max_memory_allocated()
    launches = gather_mean.launches
    steps = est.step
    skipped = int(est.skipped_steps)
    if launches != steps:
        raise AssertionError(f"gather_mean launched {launches} times in "
                             f"{steps} training steps")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        raise AssertionError(f"loss did not fall: first 5 mean {first5}, "
                             f"last 5 mean {last5}")
    if skipped != 0:
        raise AssertionError(f"{skipped} training steps skipped")
    prof = profile_device(lambda: est._train_step(next(it)),
                          "one training step", top_n=15)
    index_rule = time_index_rule(est, model, it, prof["device_busy_ms"])
    eps = EDGES_PER_STEP * TIMED_STEPS / timed_s
    ms = statistics.median(step_ms)
    r = {"steps": steps, "gather_mean_launches": launches,
         "skipped_steps": skipped, "losses": losses,
         "loss_first5_mean": first5, "loss_last5_mean": last5,
         "window_seconds": window_s, "window_steps_per_s": window_rates,
         "steps_per_s": TIMED_STEPS / timed_s,
         "edges_per_step": EDGES_PER_STEP, "edges_per_sec_per_gpu": eps,
         "step_ms": step_ms, "step_ms_median": ms,
         "host_enqueue_ms": host_ms,
         "host_enqueue_ms_median": statistics.median(host_ms),
         "device_busy_share": (prof["device_busy_ms"] * TIMED_STEPS
                               / (timed_s * 1e3)),
         "input_wait_ms": input_wait_ms, "dispatch_ms": dispatch_ms,
         "peak_device_bytes": peak, "profile": prof,
         "index_rule": index_rule,
         "remat": check_remat(est, model, it, dev)}
    log(f"train: {steps} steps of {BATCH} roots (Adam lr {TRAIN_LR}), "
        f"gather_mean launches {launches}, skipped {skipped}; "
        f"edges_per_sec_per_gpu {eps:.6g} ({EDGES_PER_STEP} edges/step, "
        f"{r['steps_per_s']:.3f} steps/s; windows "
        + ", ".join(f"{x:.3f}" for x in window_rates)
        + f" steps/s); step_ms median {ms:.3f} (events), host enqueue "
        f"{r['host_enqueue_ms_median']:.3f} ms/step; device busy "
        f"{r['device_busy_share']:.1%} of the timed windows (profiled "
        f"busy ms x steps / wall); timed windows: {input_wait_ms:.1f} ms "
        f"building batches, {dispatch_ms:.1f} ms dispatching steps; "
        f"peak device memory {peak / 2**30:.2f} GiB; loss first 5 "
        f"{first5:.4f} -> last 5 "
        f"{last5:.4f}")
    return r


def time_index_rule(est, model, it, step_busy_ms: float) -> dict:
    """What jnp.take's fill rule costs a step: the hop-0 and hop-1
    gathers through take_rows against plain indexing of the same rows
    (CUDA events), beside the step's profiled device time."""
    batch = {**next(it), **est.static_batch}
    with torch.no_grad():
        rows = model.sample_rows(batch)[:-1]
    table = batch["feature_table"]
    ms = time_ms(lambda: [take_rows(table, r) for r in rows])
    plain = time_ms(lambda: [table[r.long()] for r in rows])
    share = (ms - plain) / step_busy_ms
    log(f"index rule: hop-0/1 gathers {ms:.4f} ms with take_rows vs "
        f"{plain:.4f} ms plain indexing (+{ms - plain:.4f} ms a step, "
        f"{share:.2%} of the profiled step's device time)")
    return {"take_rows_ms": ms, "plain_index_ms": plain,
            "added_ms": ms - plain, "step_share": share}


def check_remat(est, model, it, dev) -> dict:
    """One step's loss and gradients from the trained state with
    remat=True against the plain model: the same loss, gradients within
    1e-5 of the largest, and gather_mean launched twice (forward, and
    again in the backward pass)."""
    remat = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=model.uniform_sampling, remat=True).to(dev)
    remat.load_state_dict(model.state_dict())
    batch = {**next(it), **est.static_batch}
    out = {}
    for name, m in (("plain", model), ("remat", remat)):
        m.train()
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = gather_mean.launches
        res = m(batch)
        res.loss.backward()
        torch.cuda.synchronize()
        out[name] = (res.loss.detach(),
                     {n: p.grad.detach().clone()
                      for n, p in m.named_parameters()},
                     gather_mean.launches - n0,
                     torch.cuda.max_memory_allocated())
    (lp, gp, np_, mp), (lr, gr, nr, mr) = out["plain"], out["remat"]
    big = max(float(g.abs().max()) for g in gp.values())
    err = max(max_abs_err(gr[n], gp[n]) for n in gp)
    loss_diff = abs(float(lr) - float(lp))
    log(f"remat: loss {float(lr):.6f} vs {float(lp):.6f} (diff "
        f"{loss_diff:.3g}), max grad err {err:.3g} (tol {1e-5 * big:.3g}), "
        f"gather_mean launches {nr} vs {np_}; peak device memory "
        f"{mr / 2**30:.2f} vs {mp / 2**30:.2f} GiB")
    if not (loss_diff == 0.0 and err <= 1e-5 * big and nr == 2 and np_ == 1):
        raise AssertionError("remat step disagrees with the plain step")
    return {"loss_diff": loss_diff, "max_grad_err": err,
            "grad_tol": 1e-5 * big, "launches": nr, "plain_launches": np_,
            "peak_bytes": mr, "plain_peak_bytes": mp}


def flagship_estimator(store, table, node_types, dev, **cfg):
    """The flagship model (random weights from seed 0) in a NodeEstimator
    over the path's tables, with bench.py's training parameters."""
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0))
    return NodeEstimator(
        model, dict(batch_size=BATCH, learning_rate=TRAIN_LR,
                    optimizer="adam", log_steps=1 << 30, checkpoint_steps=0,
                    train_node_type=-1, seed=0, **cfg),
        node_types, store, table, device=dev)


def phase_loop(store, table, node_types, dev, k: int = LOOP_K) -> dict:
    """NodeEstimator.train at steps_per_loop = k (32) as bench.py drives it:
    the prefetch thread (depth 3) builds each batch and copies its roots
    to the card; K + 2 warm-up steps; 3 timed windows on the host clock
    with a synchronize at the window edges only."""
    est = flagship_estimator(store, table, node_types, dev,
                             steps_per_loop=k)
    it = make_feeder(est.train_input_fn(), workers=0, depth=FEEDER_DEPTH)
    try:
        return _drive_loop(est, it, k)
    finally:
        it.close()


def _phase_sums(est) -> tuple:
    """Host ms summed so far in the estimator's input_wait and
    device_step phases (obs histograms)."""
    return (est._hist_input_wait.value["sum"],
            est._hist_device_step.value["sum"])


def _drive_loop(est, it, k: int) -> dict:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_mean.launches = 0
    warm = k + 2
    t0 = time.monotonic()
    losses = est.train(iter([next(it) for _ in range(warm)]),
                       max_steps=warm)["losses"]
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    window_s, window_rates = [], []
    sums0 = _phase_sums(est)
    for _ in range(WINDOWS):
        done = est.step
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = est.train(it, max_steps=done + LOOP_WINDOW_STEPS)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        window_s.append(dt)
        window_rates.append((res["global_step"] - done) / dt)
        losses += res["losses"]
    input_wait_ms, dispatch_ms = (
        float(x) for x in np.subtract(_phase_sums(est), sums0))
    launches = gather_mean.launches
    loop = est._graphed
    steps, replays = est.step, loop.replays
    per_replay = loop.launches_per_replay
    eager = launches - loop.captures * per_replay
    device_launches = eager + replays * per_replay
    peak = torch.cuda.max_memory_allocated()
    skipped = int(est.skipped_steps)
    if per_replay != k or device_launches != steps or eager <= 0:
        raise AssertionError(
            f"gather_mean: {launches} host launches, {per_replay} recorded "
            f"per {k}-step window, {loop.captures} captures, "
            f"{replays} replays: {device_launches} launches on the "
            f"card for {steps} steps")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5 or skipped != 0:
        raise AssertionError(f"loss first 5 {first5} -> last 5 {last5}, "
                             f"{skipped} skipped steps")
    # one replay at a time: CUDA events around it, the host's time to
    # enqueue it (copies of the window's roots, re-seeding, replay,
    # clones), batches prebuilt
    replay_ms, host_ms = [], []
    for _ in range(WINDOWS):
        window = [next(it) for _ in range(k)]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loop.run(est, window)
        stop.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        replay_ms.append(start.elapsed_time(stop))
    windows = [[next(it) for _ in range(k)] for _ in range(2)]
    prof = profile_device(lambda: loop.run(est, windows.pop()),
                          f"one replay of the {k}-step graph", top_n=15)
    if prof["device_busy_ms"] > 0 and prof["gather_mean_calls"] != k:
        raise AssertionError(f"{prof['gather_mean_calls']} gather_mean "
                             f"kernels in one {k}-step replay")
    timed_steps = WINDOWS * LOOP_WINDOW_STEPS
    timed_s = sum(window_s)
    eps = EDGES_PER_STEP * timed_steps / timed_s
    busy_step_ms = prof["device_busy_ms"] / k
    r = {"steps_per_loop": k, "feeder_depth": FEEDER_DEPTH,
         "steps": steps, "warmup_steps": warm, "warmup_seconds": warm_s,
         "gather_mean_host_launches": launches,
         "gather_mean_launches_per_replay": per_replay,
         "captures": loop.captures, "replays": replays,
         "gather_mean_device_launches": device_launches,
         "skipped_steps": skipped, "losses": losses,
         "loss_first5_mean": first5, "loss_last5_mean": last5,
         "window_seconds": window_s, "window_steps_per_s": window_rates,
         "steps_per_s": timed_steps / timed_s,
         "edges_per_sec_per_gpu": eps,
         "replay_ms": replay_ms, "replay_ms_median": statistics.median(
             replay_ms),
         "host_ms_per_replay": host_ms,
         "host_ms_per_step": statistics.median(host_ms) / k,
         "device_busy_ms_per_step": busy_step_ms,
         "device_busy_share": busy_step_ms * timed_steps / (timed_s * 1e3),
         "replay_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
         "input_wait_ms": input_wait_ms, "dispatch_ms": dispatch_ms,
         "device_edges_per_s": EDGES_PER_STEP * k / (
             statistics.median(replay_ms) / 1e3),
         "peak_device_bytes": peak, "profile": prof}
    log(f"loop: {steps} steps at steps_per_loop {k} ({loop.captures} "
        f"capture, {replays} replays), gather_mean {launches} host "
        f"launches, {per_replay} per replayed window, {device_launches} on "
        f"the card == steps; edges_per_sec_per_gpu {eps:.6g} "
        f"({r['steps_per_s']:.3f} steps/s; windows "
        + ", ".join(f"{x:.3f}" for x in window_rates)
        + f" steps/s); replay {r['replay_ms_median']:.3f} ms (events) = "
        f"{r['replay_ms_median'] / k:.3f} ms/step; host "
        f"{r['host_ms_per_step']:.4f} ms/step to enqueue; device busy "
        f"{r['device_busy_share']:.1%} of the timed windows, "
        f"{r['replay_busy_share']:.1%} of the profiled replay; "
        f"{prof['gather_mean_calls']} gather_mean kernels in it; timed "
        f"windows: {input_wait_ms:.1f} ms waiting for batches, "
        f"{dispatch_ms:.1f} ms dispatching; peak "
        f"device memory {peak / 2**30:.2f} GiB; loss first 5 {first5:.4f} "
        f"-> last 5 {last5:.4f}")
    return r


def check_graph_vs_eager(store, table, node_types, dev) -> dict:
    """LOOP_EQ_WINDOWS windows of 32 steps at K = 32 (the first eager on
    the capture stream, the rest graph replays) and at K = 1, from the
    same weights on the same batches: losses, parameters and Adam's
    moments and steps equal bit for bit."""
    steps = LOOP_EQ_WINDOWS * LOOP_K
    feed = flagship_estimator(store, table, node_types, dev).train_input_fn()
    batches = [next(feed) for _ in range(steps)]
    runs = []
    for k in (LOOP_K, 1):
        est = flagship_estimator(store, table, node_types, dev,
                                 steps_per_loop=k)
        res = est.train(iter(batches), max_steps=steps)
        runs.append((est, res["losses"]))
    (eg, lg), (ee, le) = runs
    diffs = {"losses": float(np.max(np.abs(np.subtract(lg, le))))}
    for name, p in ee.model.state_dict().items():
        diffs[name] = max_abs_err(eg.model.state_dict()[name], p)
    sg, se = (e.optimizer.state_dict()["state"] for e in (eg, ee))
    for i in se:
        for n in se[i]:
            diffs[f"adam[{i}].{n}"] = max_abs_err(sg[i][n], se[i][n])
    worst = max(diffs.values())
    replays = eg._graphed.replays
    log(f"graph vs eager: {steps} steps at K = {LOOP_K} ({replays} replays) "
        f"and K = 1 from the same weights and batches: largest difference "
        f"{worst:.3g} over losses, {len(ee.model.state_dict())} parameters "
        f"and {sum(len(v) for v in se.values())} Adam state tensors "
        f"(bit for bit: {worst == 0.0})")
    if not (worst == 0.0 and replays == LOOP_EQ_WINDOWS - 1):
        raise AssertionError(f"graph replay differs from the eager steps: "
                             f"{diffs}")
    return {"steps": steps, "replays": replays, "max_abs_diff": worst,
            "diffs": diffs}


def phase_quality() -> dict:
    """fit_citation on the cora stand-in through the port's runner, on
    the card, one run per seed; the runner's own output goes to the
    record."""
    f1, logs = [], []
    for seed in QUALITY_SEEDS:
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = run_graphsage.main(["--device_sampler", "--int8_features",
                                      "--seed", str(seed)])
        secs = time.monotonic() - t0
        logs.append(buf.getvalue())
        if res["train_skipped_steps"] != 0:
            raise AssertionError(f"cora seed {seed}: skipped steps")
        f1.append(float(res["test_metric"]))
        log(f"quality: cora seed {seed}: test micro-F1 {f1[-1]:.4f} "
            f"(best step {res['best_step']}, {secs:.1f}s)")
    mean = float(np.mean(f1))
    gate = abs(mean - QUALITY_ROW) <= QUALITY_BAND
    log(f"quality: cora mean test micro-F1 {mean:.4f} over seeds "
        f"{list(QUALITY_SEEDS)} (floor {QUALITY_FLOOR}; RESULTS.md row "
        f"{QUALITY_ROW} +- {QUALITY_BAND}: {'met' if gate else 'not met'})")
    if not mean >= QUALITY_FLOOR:
        raise AssertionError(f"cora mean micro-F1 {mean} < {QUALITY_FLOOR}")
    return {"seeds": list(QUALITY_SEEDS), "test_micro_f1": f1,
            "mean": mean, "gate_met": gate, "logs": logs}


def phase_small_vs_cpu(dev: torch.device) -> dict:
    """A small input through the card (kernel) and through the CPU path
    (plain versions) with the same weights and replayed uniforms: the
    embeddings agree within 1e-4 (int8 + float32 scale)."""
    g = synthetic_citation(n=2000, d=FEAT_DIM, num_classes=NUM_CLASSES,
                           seed=1, intra_degree=6.0, inter_degree=2.0)
    feats = np.concatenate([g.features, np.zeros((1, FEAT_DIM), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, NUM_CLASSES), np.float32)])
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=True, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    roots = rng.integers(0, 2000, 64).astype(np.int32)
    uniforms, n = [], len(roots)
    for k in FANOUTS:
        uniforms.append(rng.random((n, k), dtype=np.float32))
        n *= k
    embs = []
    for d in (dev, torch.device("cpu")):
        store = DeviceFeatureStore.from_arrays(feats, labels,
                                               quantize="int8", device=d)
        tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=CAP,
                                           device=d)
        m = model.to(d)
        batch = {"rows": [torch.from_numpy(roots).to(d)], "sample_seed": 0,
                 "sample_uniforms": [torch.from_numpy(u).to(d)
                                     for u in uniforms],
                 **tab.tables, "feature_table": store.features,
                 "feature_scale": store.feature_scale,
                 "label_table": store.labels}
        with torch.inference_mode():
            embs.append(m(batch).embedding.cpu())
    err = max_abs_err(embs[0], embs[1])
    if not err <= 1e-4:
        raise AssertionError(f"card vs CPU on a small input: {err} > 1e-4")
    log(f"small input: card vs CPU embeddings max abs err {err:.3g} "
        f"(tol 1e-4)")
    return {"max_abs_err": err, "tol": 1e-4}


def phase_serve(ids: np.ndarray, emb: np.ndarray, dev: torch.device) -> dict:
    eng = EmbeddingEngine(ids, emb, device=dev)
    rng = np.random.default_rng(3)
    unknown = np.uint64(int(ids[-1]) + 1_000_000_007)
    t0 = time.monotonic()
    requests = 0
    for _ in range(4):
        q = rng.choice(ids, 256).astype(np.uint64)
        q[7] = unknown
        got = eng.embed(q)
        want = emb[q.astype(np.int64).clip(0, len(ids) - 1)]
        want[7] = 0.0
        if not np.array_equal(got, want):
            raise AssertionError("embed disagrees with direct indexing")
        src = rng.choice(ids, 256).astype(np.uint64)
        dst = rng.choice(ids, 256).astype(np.uint64)
        dst[0] = unknown
        s = eng.score(src, dst)
        ref = (emb[src.astype(np.int64)]
               * emb[dst.astype(np.int64).clip(0, len(ids) - 1)]).sum(-1)
        ref[0] = 0.0
        if not np.allclose(s, ref, rtol=1e-5, atol=1e-4):
            raise AssertionError("score disagrees with row-wise dots")
        requests += 2
    secs = time.monotonic() - t0
    log(f"serve: {requests} requests (embed/score x256 ids, one unknown "
        f"id each) agree with direct indexing; {secs / requests * 1e3:.2f} "
        f"ms/request")
    return {"requests": requests, "ms_per_request": secs / requests * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON to this path")
    ap.add_argument("--extra-loop-k", type=int, action="append", default=[],
                    help="also time the loop phase at this steps_per_loop "
                         "(repeatable); phase 7 always runs K = 32")
    ap.add_argument("--baseline-source", default=None,
                    help="an earlier gather_mean.cu with the first kernel's "
                         "C entry, timed against the current one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    record = {"device": phase_device()}
    record["build"], baseline = phase_build(args.baseline_source)
    store, table, node_types, record["graph"] = phase_graph(dev)
    model = DeviceSampledGraphSage(
        NUM_CLASSES, FEAT_DIM, multilabel=False, dim=DIM, fanouts=FANOUTS,
        uniform_sampling=table.uniform_rows,
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    inf = NodeInferencer(model, store, table, batch_size=BATCH)
    probe = {**next(inf.infer_input_fn(np.arange(BATCH, dtype=np.uint64))),
             **inf.static_batch}
    with torch.inference_mode():
        deepest = model.sample_rows(probe)[-1].view(BATCH * FANOUTS[0], -1)
    record["kernels"] = phase_kernels(store, deepest, dev, baseline)
    del deepest, probe
    record["slice"], ids, emb = phase_slice(inf, model)
    record["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    record["train"] = phase_train(store, table, node_types, dev)
    record["loop"] = phase_loop(store, table, node_types, dev)
    record["loop"]["graph_vs_eager"] = check_graph_vs_eager(
        store, table, node_types, dev)
    record["loop_extra"] = [phase_loop(store, table, node_types, dev, k)
                            for k in args.extra_loop_k]
    record["quality"] = phase_quality()
    record["small_vs_cpu"] = phase_small_vs_cpu(dev)
    record["serve"] = phase_serve(ids, emb, dev)
    main_case = record["kernels"]["cases"][0]
    kernels = {"kernels": [{
        "name": "gather_mean", "route": "cuda",
        "source": "euler_tpu_torch/csrc/gather_mean.cu",
        "replaces": "euler_tpu/ops/pallas_ops.py:105",
        "replaces_function": "euler_tpu/ops/pallas_ops.py:"
                             "_pallas_gather_mean",
        "launches": record["slice"]["gather_mean_launches"],
        "train_launches": record["train"]["gather_mean_launches"],
        "loop_host_launches": record["loop"]["gather_mean_host_launches"],
        "loop_launches_per_replay":
            record["loop"]["gather_mean_launches_per_replay"],
        "loop_replays": record["loop"]["replays"],
        "loop_device_launches":
            record["loop"]["gather_mean_device_launches"],
        "launched": record["slice"]["gather_mean_launches"] > 0,
        "checked_vs_plain": True,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "cases": record["kernels"]["cases"]}]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
