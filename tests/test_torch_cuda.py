"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc (marked
`cuda`; they skip without a card). This file imports no JAX, so it runs
on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from euler_tpu_torch.ops import gather_mean as gather_mean_module
from euler_tpu_torch.ops.gather_mean import (
    gather_mean, gather_mean_reference, launch_plan,
)
from euler_tpu_torch.parallel.feature_store import quantize_int8

CASES = ["int8_bf16", "int8_f32", "f32", "bf16"]


def _assert_matches_plain(got, ref):
    """Kernel vs plain version: the same dtype, shape and NaN positions;
    elsewhere float32 outputs within 1e-5 of the largest value
    (summation order and where 1/k and the scale multiply), bfloat16
    outputs within 2^-7 of the largest (one bf16 rounding)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, f = got.float().cpu(), ref.float().cpu()
    assert torch.equal(torch.isnan(g), torch.isnan(f))
    ok = ~torch.isnan(f)
    big = float(f[ok].abs().max()) if ok.any() else 0.0
    tol = (2 ** -7 if got.dtype == torch.bfloat16 else 1e-5) * big
    if ok.any():
        assert float((g[ok] - f[ok]).abs().max()) <= tol


def _table(case, n_table, d, rng, device="cuda", offset=0):
    """A table of `case` on the card; offset > 0 places it `offset`
    elements into a larger buffer, so its address is that far off."""
    table = rng.normal(size=(n_table, d)).astype(np.float32)
    if case.startswith("int8"):
        q, scale = quantize_int8(table)
        t = torch.from_numpy(q)
        s = torch.from_numpy(scale).to(
            torch.bfloat16 if case == "int8_bf16" else torch.float32)
    else:
        t = torch.from_numpy(table).to(
            torch.bfloat16 if case == "bf16" else torch.float32)
        s = None
    t = t.to(device)
    if offset:
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
        buf[offset:] = t.reshape(-1)
        t = buf[offset:].view(n_table, d)
    return t, (s.to(device) if s is not None else None)


def _rows(rng, n, k, n_table):
    """[n, k] int32 rows with the wrap/fill indices of jnp.take: -1,
    -N (wrap), N, N + 5, -N - 1 (fill)."""
    rows = rng.integers(0, n_table, (n, k)).astype(np.int32)
    for i, v in enumerate((-1, -n_table, n_table, n_table + 5,
                           -n_table - 1)):
        rows[1 + 3 * i, (7 * i) % k] = v
    return torch.from_numpy(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8_bf16", "int8_f32", "f32", "bf16"])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    rng = np.random.default_rng(6)
    table = rng.normal(size=(5000, 100)).astype(np.float32)
    rows = rng.integers(0, 5000, (4096, 10)).astype(np.int32)
    rows[0, 0] = 4999  # last row: bounds are exact
    if case.startswith("int8"):
        q, scale = quantize_int8(table)
        t = torch.from_numpy(q).cuda()
        s = torch.from_numpy(scale).cuda().to(
            torch.bfloat16 if case == "int8_bf16" else torch.float32)
    else:
        t = torch.from_numpy(table).cuda().to(
            torch.bfloat16 if case == "bf16" else torch.float32)
        s = None
    r = torch.from_numpy(rows).cuda()
    before = gather_mean.launches
    got = gather_mean(t, r, s)
    torch.cuda.synchronize()
    assert gather_mean.launches == before + 1
    ref = gather_mean_reference(t, r, s)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    big = float(ref.float().abs().max())
    tol = 2 ** -7 * big if got.dtype == torch.bfloat16 else 1e-5 * big
    assert float((got.float() - ref.float()).abs().max()) <= tol
    bad = r.clone()
    bad[1, 3] = t.shape[0]  # out of range: jnp.take's fill value
    bad[2, 0] = -1  # wraps to the last row
    out = gather_mean(t, bad, s)
    _assert_matches_plain(out, gather_mean_reference(t, bad, s))
    assert torch.isfinite(out[0].float()).all()
    assert torch.isfinite(out[2].float()).all()
    # a float table's fill is NaN; an int8 table's is -128, then scaled
    assert torch.isnan(out[1].float()).all() == (not case.startswith("int8"))


@pytest.mark.cuda
def test_cuda_training_matches_the_cpu_and_guards_nonfinite_steps():
    """3 Adam steps of DeviceSampledGraphSage on the card (gather_mean
    kernel, fused Adam) and on the CPU from the same weights and
    replayed uniforms: params within 1e-5 of the largest; then a NaN
    table on the card: the update is skipped on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    from euler_tpu_torch.dataset.synthetic import synthetic_citation
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator
    from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    g = synthetic_citation(n=2000, d=32, num_classes=5, seed=4)
    feats = np.concatenate([g.features, np.zeros((1, 32), np.float32)])
    labels = np.concatenate([g.onehot_labels(), np.zeros((1, 5), np.float32)])
    rng = np.random.default_rng(7)
    batches = []
    for i in range(3):
        roots = rng.integers(0, 2000, 64).astype(np.int32)
        batches.append({"rows": [roots], "sample_seed": i + 1,
                        "sample_uniforms": [
                            rng.random((64, 5), dtype=np.float32),
                            rng.random((320, 3), dtype=np.float32)]})
    ests = []
    for dev in ("cuda", "cpu"):
        store = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                               device=dev)
        tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=16,
                                           device=dev)
        m = DeviceSampledGraphSage(5, 32, multilabel=False, dim=16,
                                   fanouts=(5, 3),
                                   generator=torch.Generator().manual_seed(3))
        est = BaseEstimator(m, {"checkpoint_steps": 0}, device=dev)
        est.static_batch = {**tab.tables, "feature_table": store.features,
                            "feature_scale": store.feature_scale,
                            "label_table": store.labels}
        before = gather_mean.launches
        est.train(iter(batches), max_steps=3)
        assert gather_mean.launches - before == (3 if dev == "cuda" else 0)
        ests.append(est)
    card, cpu = (e.model.state_dict() for e in ests)
    big = max(float(v.abs().max()) for v in cpu.values())
    for k, v in cpu.items():
        assert float((card[k].cpu() - v).abs().max()) <= 1e-5 * big, k
    est = ests[0]
    params = {k: v.clone() for k, v in est.model.state_dict().items()}
    nan_table = est.static_batch["feature_scale"].clone()
    nan_table[0] = float("nan")
    est.static_batch["feature_scale"] = nan_table
    res = est.train(iter(batches[:1]), max_steps=4)
    assert res["skipped_steps"] == 1 and est.step == 4
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, params[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("d", [1, 7, 100, 128, 1433])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_grid_matches_plain(case, d, k):
    """The four dtype cases x odd and wide widths x k below, at and above
    one 16-row load chunk and one warp of indices, on n = 1003 rows (not
    a multiple of rows per block), with wrapped and filled indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    rng = np.random.default_rng(100 * d + k)
    t, s = _table(case, 300, d, rng)
    r = _rows(rng, 1003, k, 300).cuda()
    before = gather_mean.launches
    got = gather_mean(t, r, s)
    torch.cuda.synchronize()
    assert gather_mean.launches == before + 1
    _assert_matches_plain(got, gather_mean_reference(t, r, s))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [7, 100])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_on_misaligned_tables(case, d):
    """A row view t[1:] and a table one element into its buffer: the plan
    narrows the vector to the real address, and the kernel refuses a
    plan whose vector the address does not allow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")
    rng = np.random.default_rng(d)
    whole, s = _table(case, 301, d, rng)
    r = _rows(rng, 517, 10, 300).cuda()
    for t in (whole[1:], _table(case, 300, d, rng, offset=1)[0]):
        got = gather_mean(t, r, s)
        torch.cuda.synchronize()
        _assert_matches_plain(got, gather_mean_reference(t, r, s))
    out = torch.empty(517, d, dtype=got.dtype, device="cuda")
    plan = launch_plan(t, r, out, s)
    assert plan.vec_bytes == t.element_size()
    if d % 4 == 0:
        wide = plan._replace(vec_bytes=4 * t.element_size(), elems=4,
                             vectors_per_row=d // 4,
                             lanes=min(d // 4, 32), col_blocks=1)
        before = gather_mean.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            gather_mean_module._launch(t, r, s, out, wide)
        assert gather_mean.launches == before


# -- the K-step CUDA graph (estimator/graphed_loop.py) ----------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (runs on the card)")


def _training_setup(kind, dev="cuda"):
    """(tables, node_types, model factory, params) for a NodeEstimator:
    "flagship" has bench.py's shapes (batch 32768, fanouts [15, 10], dim
    128, 100 int8 features with a bf16 scale, 16 classes, Adam lr 0.01)
    on a 60,000-node products-like graph; "cora" the cora runner's
    (2708 nodes, 1433 int8 features with a float32 scale, fanouts
    [10, 10], dim 64, batch 64, dropout 0.6)."""
    from euler_tpu_torch.dataset.synthetic import (
        products_like, synthetic_citation,
    )
    from euler_tpu_torch.models.graphsage import DeviceSampledGraphSage
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    if kind == "flagship":
        g = products_like(60_000, 50, 100, 16)
        d, c, scale = 100, 16, torch.bfloat16
        mk = dict(dim=128, fanouts=(15, 10), dropout=0.0)
        params = dict(batch_size=32768, learning_rate=0.01,
                      train_node_type=-1)
    else:
        g = synthetic_citation(n=2708, d=1433, num_classes=7, seed=0)
        d, c, scale = 1433, 7, torch.float32
        mk = dict(dim=64, fanouts=(10, 10), dropout=0.6)
        params = dict(batch_size=64, learning_rate=0.003)
    feats = np.concatenate([g.features, np.zeros((1, d), np.float32)])
    labels = np.concatenate([g.onehot_labels(), np.zeros((1, c), np.float32)])
    store = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                           scale_dtype=scale, device=dev)
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=32,
                                       device=dev)

    def model():
        return DeviceSampledGraphSage(
            c, d, multilabel=False, uniform_sampling=tab.uniform_rows,
            generator=torch.Generator().manual_seed(0), **mk)

    return store, tab, g.node_types, model, params


def _estimator(setup, dev="cuda", **cfg):
    from euler_tpu_torch.estimator.estimators import NodeEstimator

    store, tab, node_types, model, params = setup
    return NodeEstimator(model(), {**params, "checkpoint_steps": 0,
                                   "log_steps": 1 << 30, **cfg},
                         node_types, store, tab, device=dev)


def _assert_same_state(a, b):
    """Parameters, optimizer state (Adam's moments and step) and the
    guard's count, bit for bit."""
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sa, sb = (e.optimizer.state_dict()["state"] for e in (a, b))
    assert sa.keys() == sb.keys()
    for k in sa:
        for n in sa[k]:
            assert torch.equal(sa[k][n], sb[k][n]), (k, n)
    assert int(a.skipped_steps) == int(b.skipped_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k", [("flagship", 32), ("cora", 8)])
def test_cuda_graph_windows_match_eager_steps(kind, k):
    """3 windows and a tail of 2 at steps_per_loop = K (the first window
    eager on the capture stream, then two graph replays, each re-seeding
    the K sampling and, on cora, K dropout generators) against K = 1 on
    the same batches: the same losses, parameters and Adam moments, bit
    for bit; gather_mean recorded K times in the graph."""
    _need_card()
    setup = _training_setup(kind)
    steps = 3 * k + 2
    feed = _estimator(setup).train_input_fn()
    batches = [next(feed) for _ in range(steps)]
    graphed = _estimator(setup, steps_per_loop=k)
    eager = _estimator(setup)
    rg = graphed.train(iter(batches), max_steps=steps)
    re_ = eager.train(iter(batches), max_steps=steps)
    loop = graphed._graphed
    assert (loop.captures, loop.replays) == (1, 2)
    assert loop.launches_per_replay == k
    assert rg["global_step"] == re_["global_step"] == steps
    assert rg["losses"] == re_["losses"]
    assert np.isfinite(rg["losses"]).all()
    _assert_same_state(graphed, eager)


def _labelled(batches, store, nan_at=()):
    """Batches with their labels as a batch tensor, NaN at `nan_at`."""
    out = []
    for i, b in enumerate(batches):
        lab = store.labels[b["rows"][0].long()].clone()
        if i in nan_at:
            lab[0, 0] = float("nan")
        out.append({**b, "labels": lab})
    return out


@pytest.mark.cuda
def test_cuda_graph_skips_nonfinite_steps():
    """K = 4 on the cora setup with a labels tensor in the batch: a window
    of NaN labels replays with every step skipped (parameters and
    optimizer state as they were, 4 skips counted), a window with one
    NaN step matches the eager steps (that step skipped)."""
    _need_card()
    setup = _training_setup("cora")
    store = setup[0]
    feed = _estimator(setup).train_input_fn()
    raw = [next(feed) for _ in range(12)]
    batches = _labelled(raw, store, nan_at={4, 5, 6, 7, 9})
    graphed = _estimator(setup, steps_per_loop=4)
    graphed.train(iter(batches[:4]), max_steps=4)  # eager, then capture
    before = {k: v.clone() for k, v in graphed.model.state_dict().items()}
    moments = {k: {n: t.clone() for n, t in s.items()} for k, s in
               graphed.optimizer.state_dict()["state"].items()}
    res = graphed.train(iter(batches[4:8]), max_steps=8)
    assert graphed._graphed.replays == 1
    assert res["skipped_steps"] == 4 and not np.isfinite(res["losses"]).any()
    for k, v in graphed.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, s in graphed.optimizer.state_dict()["state"].items():
        for n, t in s.items():
            assert torch.equal(t, moments[k][n]), (k, n)
    graphed.train(iter(batches[8:]), max_steps=12)
    eager = _estimator(setup)
    eager.train(iter(batches), max_steps=12)
    assert int(graphed.skipped_steps) == 5
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
def test_cuda_graph_recaptures_after_restore(tmp_path):
    """16 steps at K = 4 with a checkpoint at 8; restoring it replaces
    the optimizer's state tensors, so the graph is dropped and captured
    again, and the 8 steps retrained from it end where the first run
    ended, bit for bit."""
    _need_card()
    setup = _training_setup("cora")
    feed = _estimator(setup).train_input_fn()
    batches = [next(feed) for _ in range(16)]
    est = _estimator(setup, steps_per_loop=4, checkpoint_steps=8)
    est.model_dir = str(tmp_path)
    est.train(iter(batches), max_steps=16)
    first = {k: v.clone() for k, v in est.model.state_dict().items()}
    (tmp_path / "checkpoints" / "ckpt-16.pt").unlink()
    assert est.restore_checkpoint() == 8
    assert est._graphed.graph is None
    res = est.train(iter(batches[8:]), max_steps=16)
    assert res["global_step"] == 16
    assert (est._graphed.captures, est._graphed.replays) == (2, 4)
    for k, v in est.model.state_dict().items():
        assert torch.equal(v, first[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adagrad", "rmsprop"])
def test_cuda_optimizer_steps_capture(name):
    """Each optimizer's step, with the guard's found_inf, captured in a
    CUDA graph and replayed: the same parameters and state as eager
    steps on the same gradients, bit for bit, and a step with found_inf
    set leaves them as they were."""
    _need_card()
    from euler_tpu_torch.utils import optimizers as opt_lib

    rng = np.random.default_rng(1)
    init = [rng.normal(size=s).astype(np.float32) for s in ((33, 7), (7,))]
    grads = [[rng.normal(size=x.shape).astype(np.float32) for x in init]
             for _ in range(4)]
    runs = []
    for graphed in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(x).cuda()) for x in init]
        opt = opt_lib.get(name, ps, 0.01)
        flag = torch.zeros((), device="cuda")
        opt.found_inf = flag
        for p, g_ in zip(ps, grads[0]):
            p.grad = torch.from_numpy(g_).cuda()
        opt.step()  # the first step eagerly: lazy state
        if graphed:
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.graph(graph, stream=side):
                opt.step()
        for i, gs in enumerate(grads[1:]):
            flag.fill_(1.0 if i == 1 else 0.0)
            for p, g_ in zip(ps, gs):
                p.grad.copy_(torch.from_numpy(g_))
            graph.replay() if graphed else opt.step()
        torch.cuda.synchronize()
        runs.append(([p.detach().clone() for p in ps],
                     {k: {n: t.clone() for n, t in s.items()
                          if isinstance(t, torch.Tensor)}
                      for k, s in opt.state_dict()["state"].items()}))
    (pa, sa), (pb, sb) = runs
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for k in sa:
        for n in sa[k]:
            assert torch.equal(sa[k][n], sb[k][n]), (k, n)
