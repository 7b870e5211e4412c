"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc (marked
`cuda`; they skip without a card). This file imports no JAX, so it runs
on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
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
    """(tables, engine graph, model factory, params) for a NodeEstimator:
    "flagship" has bench.py's shapes (batch 32768, fanouts [15, 10], dim
    128, 100 int8 features with a bf16 scale, 16 classes, Adam lr 0.01)
    on a 60,000-node products-like graph; "cora" the cora runner's
    (2708 nodes, 1433 int8 features with a float32 scale, fanouts
    [10, 10], dim 64, batch 64, dropout 0.6)."""
    from euler_tpu_torch.dataset import engine_from_arrays
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
    graph = engine_from_arrays(g).engine
    store = DeviceFeatureStore(graph, ["feature"], label_fid="label",
                               label_dim=c, dtype=scale, quantize="int8",
                               device=dev)
    tab = DeviceNeighborTable(graph, cap=32, device=dev)

    def model():
        return DeviceSampledGraphSage(
            c, d, multilabel=False, uniform_sampling=tab.uniform_rows,
            generator=torch.Generator().manual_seed(0), **mk)

    return store, tab, graph, model, params


def _estimator(setup, dev="cuda", **cfg):
    from euler_tpu_torch.estimator.estimators import NodeEstimator

    store, tab, graph, model, params = setup
    return NodeEstimator(model(), {**params, "checkpoint_steps": 0,
                                   "log_steps": 1 << 30, **cfg},
                         graph, None, feature_store=store,
                         device_sampler=tab, device=dev)


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
        rows = torch.as_tensor(b["rows"][0], device=store.labels.device)
        lab = store.labels[rows.long()].clone()
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


# -- the device-sampled unsupervised family ----------------------------------

def _unsup_setup(kind, dev="cuda"):
    """(model factory, static tables, root count) on a 60,000-node
    products-like graph with unit weights: "unsup" is
    DeviceSampledUnsupervisedSage at the full-width configuration (100
    int8 features with a bf16 scale, dim 128, fanouts [15, 10], 5
    negatives); "skipgram" is DeepWalk at bench.py --walk's (walk_len 5,
    window 1/1, 5 negatives, dim 128)."""
    from euler_tpu_torch.dataset.synthetic import products_like
    from euler_tpu_torch.models.embedding_models import DeviceSampledSkipGram
    from euler_tpu_torch.models.graphsage import DeviceSampledUnsupervisedSage
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.device_walk import DeviceNodeSampler
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    n = 60_000
    g = products_like(n, 50, 100, 16)
    tab = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=32,
                                       device=dev)
    neg = DeviceNodeSampler.from_arrays(np.ones(n, np.float32), device=dev)
    static = {**tab.tables, **neg.tables}
    if kind == "unsup":
        feats = np.concatenate([g.features, np.zeros((1, 100), np.float32)])
        store = DeviceFeatureStore.from_arrays(
            feats, quantize="int8", scale_dtype=torch.bfloat16, device=dev)
        static.update(feature_table=store.features,
                      feature_scale=store.feature_scale)

        def model():
            return DeviceSampledUnsupervisedSage(
                tab.pad_row, 100, dim=128, fanouts=(15, 10),
                uniform_sampling=tab.uniform_rows,
                generator=torch.Generator().manual_seed(0))
    else:
        def model():
            return DeviceSampledSkipGram(
                tab.pad_row, dim=128, walk_len=5,
                uniform_sampling=tab.uniform_rows,
                generator=torch.Generator().manual_seed(0))
    return model, static, n


def _unsup_estimator(model, static, dev="cuda", **cfg):
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator

    est = BaseEstimator(model, {"learning_rate": 0.01, "checkpoint_steps": 0,
                                "log_steps": 1 << 30, **cfg}, device=dev)
    est.static_batch.update(static)
    return est


@pytest.mark.cuda
def test_cuda_unsup_sage_launches_gather_mean_and_matches_the_cpu():
    """DeviceSampledUnsupervisedSage on the card launches gather_mean
    once per forward, and with the same weights and replayed uniforms
    draws the CPU path's rows exactly and gives its embedding and loss
    within 2^-7 of the largest value: the neighbor means are bf16, and
    the kernel's f32 sum may round to the other side of a bf16 value
    than the plain version's (one bf16 rounding)."""
    _need_card()
    make, static, n = _unsup_setup("unsup")
    rng = np.random.default_rng(3)
    b = 512
    roots = rng.integers(0, n, b).astype(np.int32)
    batch = {"rows": [torch.from_numpy(roots)], "sample_seed": 1,
             "sample_uniforms": [torch.from_numpy(rng.random(
                 (b * m, k), dtype=np.float32)) for m, k in ((1, 15),
                                                             (15, 10))],
             "pos_uniforms": torch.from_numpy(rng.random((b, 1),
                                                         dtype=np.float32)),
             "neg_uniforms": torch.from_numpy(rng.random((b, 5),
                                                         dtype=np.float32))}
    model = make()
    outs = []
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        tables = {k: v.to(dev) for k, v in static.items()}
        bb = {k: ([x.to(dev) for x in v] if isinstance(v, list)
                  else v.to(dev) if isinstance(v, torch.Tensor) else v)
              for k, v in batch.items()}
        before = gather_mean.launches
        with torch.no_grad():
            out = m({**bb, **tables})
            drawn = m.sample({**bb, **tables})
        assert gather_mean.launches - before == (1 if dev == "cuda" else 0)
        outs.append((out.embedding.float().cpu(), float(out.loss),
                     [x.cpu() for x in (*drawn[0], *drawn[1:])]))
    (ea, la, ra), (eb, lb, rb) = outs
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    assert torch.isfinite(ea).all()
    assert float((ea - eb).abs().max()) <= 2 ** -7 * float(eb.abs().max())
    assert la == pytest.approx(lb, rel=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["unsup", "skipgram"])
def test_cuda_graph_windows_match_eager_steps_unsupervised(kind):
    """3 windows of K = 8 and a tail of 2 (the first window eager on the
    capture stream, then two replays that re-seed each step's generator
    with the model's stream word, 29 or 23) against K = 1 on the same
    batches: the same losses, parameters and Adam moments, bit for bit.
    The embedding tables' gradients are row-sparse on the card, stepped
    by ops/row_sparse_adam.py; bit for bit here also shows its sorted
    sums of repeated ids are deterministic. gather_mean is recorded 8
    times per window in the unsupervised model, never in the
    skip-gram."""
    _need_card()
    make, static, n = _unsup_setup(kind)
    k, steps = 8, 26
    rng = np.random.default_rng(0)
    batches = [{"rows": [rng.integers(0, n, 4096).astype(np.int32)],
                "sample_seed": np.uint32(i + 1)} for i in range(steps)]
    graphed = _unsup_estimator(make(), static, steps_per_loop=k)
    eager = _unsup_estimator(make(), static)
    rg = graphed.train(iter(batches), max_steps=steps)
    re_ = eager.train(iter(batches), max_steps=steps)
    loop = graphed._graphed
    assert (loop.captures, loop.replays) == (1, 2)
    assert loop.launches_per_replay == (k if kind == "unsup" else 0)
    assert rg["losses"] == re_["losses"]
    assert np.isfinite(rg["losses"]).all()
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
def test_cuda_unsup_step_is_the_same_with_a_dense_table_gradient(
        monkeypatch):
    """DeviceSampledUnsupervisedSage, 8 eager steps of 4096 roots: its
    context table's row-sparse gradient under row_sparse_adam (8
    launches) against the dense [rows, 128] gradient under torch's fused
    Adam (0 launches), on the same batches. The first loss within the
    unsupervised cell's loss_gap_first (2.5e-7 relative) and each
    parameter's change over the 8 steps within its change_gap (3e-3 of
    the larger of the dense run's change norm and the median leaf's)."""
    _need_card()
    import torch.nn.functional as F

    from euler_tpu_torch.ops import row_sparse_adam as rsa
    from euler_tpu_torch.utils.layers import Embedding, bucketize_ids

    make, static, n = _unsup_setup("unsup")
    rng = np.random.default_rng(4)
    batches = [{"rows": [rng.integers(0, n, 4096).astype(np.int32)],
                "sample_seed": np.uint32(i + 1)} for i in range(8)]
    runs = []
    for sparse in (True, False):
        if not sparse:
            monkeypatch.setattr(Embedding, "forward", lambda self, ids:
                                F.embedding(bucketize_ids(
                                    ids, self.num_embeddings).long(),
                                    self.table))
        est = _unsup_estimator(make(), static)
        before = {k: v.detach().clone()
                  for k, v in est.model.named_parameters()}
        launches = rsa.row_sparse_adam.launches
        r = est.train(iter(batches), max_steps=8)
        assert rsa.row_sparse_adam.launches - launches == (8 if sparse
                                                           else 0)
        change = {k: (v.detach() - before[k]).double().norm().item()
                  for k, v in est.model.named_parameters()}
        runs.append((r["losses"], change))
    (ls, cs), (ld, cd) = runs
    assert abs(ls[0] - ld[0]) / abs(ld[0]) <= 2.5e-7
    median = float(np.median(list(cd.values())))
    for k in cd:
        assert abs(cs[k] - cd[k]) / max(cd[k], median) <= 3e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("name,dim", [("adam", 128), ("adamw", 128),
                                      ("adam", 10)])
def test_cuda_row_sparse_adam_in_a_graph_matches_fused_adam(name, dim):
    """K = 8 steps captured in one CUDA graph beside torch's fused
    capturable Adam (AdamW with decay 0.01): one table steps the
    row-sparse gradient of a lookup of 3000 ids with repeats (one id 40
    times) through the kernel, the other its dense form (each repeat
    added in lookup order, as the kernel sums). After an eager window,
    each of two replays, and a replay whose step 3 is skipped
    (found_inf = 1), both tables, both moments and the step counts
    within 1 float32 ulp on every element. dim 10 takes the kernel's
    one-float path. launches: 8 recorded by the capture, 0 by a
    replay."""
    _need_card()
    import torch.nn.functional as F

    from euler_tpu_torch.ops import row_sparse_adam as rsa
    from euler_tpu_torch.utils import optimizers as opt

    n, nnz, k = 100_003, 3000, 8
    rng = np.random.default_rng(7)
    ids = rng.integers(0, n, (k, nnz))
    ids[:, :40] = 5
    ids[:, -1] = n - 1
    w = torch.from_numpy(rng.normal(size=(k, nnz, dim)).astype(
        np.float32)).cuda()
    init = torch.from_numpy(rng.random((n, dim), dtype=np.float32)
                            / 20).cuda()
    # the i-th repeat of each id, added in lookup order
    ranks = []
    for row in ids:
        seen, rank = {}, np.empty(nnz, np.int64)
        for j, x in enumerate(row):
            rank[j] = seen[x] = seen.get(x, -1) + 1
        ranks.append([torch.from_numpy(np.flatnonzero(rank == r)).cuda()
                      for r in range(rank.max() + 1)])
    ids = torch.from_numpy(ids).cuda()
    a = torch.nn.Parameter(init.clone())
    b = torch.nn.Parameter(init.clone())
    kw = {"weight_decay": 0.01} if name == "adamw" else {}
    oa = opt.get(name, [a], 0.01, **kw)
    ob = (torch.optim.AdamW if name == "adamw" else torch.optim.Adam)(
        [b], lr=0.01, fused=True, capturable=True, **kw)
    flags = torch.zeros(k, device="cuda")

    def steps():
        for i in range(k):
            a.grad = None
            (F.embedding(ids[i], a, sparse=True) * w[i]).sum().backward()
            g = torch.zeros_like(b)
            for pos in ranks[i]:
                g.index_put_((ids[i][pos],), w[i][pos], accumulate=True)
            b.grad = g
            for o in (oa, ob):
                o.found_inf = flags[i]
                o.step()

    def check(step):
        assert a.grad.is_sparse
        sa, sb = oa.state[a], ob.state[b]
        assert float(sa["step"]) == float(sb["step"]) == step
        assert rsa.max_ulps(a.detach(), b.detach()) <= 1
        for key in ("exp_avg", "exp_avg_sq"):
            assert rsa.max_ulps(sa[key], sb[key]) <= 1, key

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    check(8)
    graph = torch.cuda.CUDAGraph()
    launches = rsa.row_sparse_adam.launches
    with torch.cuda.graph(graph):
        steps()
    assert rsa.row_sparse_adam.launches - launches == k
    for step in (16, 24):
        graph.replay()
        torch.cuda.synchronize()
        check(step)
    flags[3] = 1.0
    graph.replay()
    torch.cuda.synchronize()
    check(31)
    assert rsa.row_sparse_adam.launches - launches == k


# -- serving (serving/engine.py, serving/server.py) -------------------------

def _serving_bundle(seed=0, n=3000, d=64, version="v1"):
    from euler_tpu_torch.serving import ModelBundle

    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64) * 2 + 1
    return ModelBundle({}, emb, ids, meta={"bundle_version": version})


@pytest.mark.cuda
def test_cuda_engine_table_is_on_the_card_and_matches_the_cpu():
    """The engine's table lives on the card; embed equals the CPU
    engine's exactly (a gather), score within rtol/atol 1e-5 (the card
    and the CPU sum the 64 products in other orders); both pad to the
    ladder alike."""
    _need_card()
    from euler_tpu_torch.serving.engine import EmbeddingEngine

    b = _serving_bundle()
    card = EmbeddingEngine(b, "cuda", ladder=(8, 16, 32))
    cpu = EmbeddingEngine(b, "cpu", ladder=(8, 16, 32))
    card.warm()
    assert card.table.device.type == "cuda"
    assert card.table.shape == b.embeddings.shape
    rng = np.random.default_rng(1)
    for n in (1, 7, 32, 77):
        q = rng.choice(b.ids, n).astype(np.uint64)
        q[0] = np.uint64(2)  # unknown
        got, unknown = card.embed(q)
        want, _ = cpu.embed(q)
        assert unknown == 1 and got.flags.writeable
        np.testing.assert_array_equal(got, want)
        dst = np.roll(q, 1)
        np.testing.assert_allclose(card.score(q, dst)[0],
                                   cpu.score(q, dst)[0], rtol=1e-5,
                                   atol=1e-5)
    assert card.padded_shapes == {"gather": {8, 16, 32},
                                  "score": {8, 16, 32}}


@pytest.mark.cuda
def test_cuda_server_swaps_tables_on_the_card(tmp_path):
    """An InferenceServer on the card: embed answers v1's rows, then a
    swap over the wire puts v2's table on the card beside v1's and flips;
    answers are v2's, the old table is freed, shapes stay in the ladder."""
    _need_card()
    from euler_tpu_torch.serving import InferenceServer, ServingClient

    v1, v2 = _serving_bundle(0), _serving_bundle(1, version="v2")
    d2 = v2.save(str(tmp_path / "v2"))
    srv = InferenceServer(v1, service="cuda_swap", max_batch=32)
    try:
        with ServingClient(endpoints=f"hosts:127.0.0.1:{srv.port}") as cli:
            q = v1.ids[[0, 5, 2999]]
            np.testing.assert_array_equal(cli.embed(q),
                                          v1.embeddings[[0, 5, 2999]])
            assert srv._engine.table.device.type == "cuda"
            before = torch.cuda.memory_allocated()
            reply = cli.swap_fleet(d2)
            assert list(reply.values())[0]["bundle_version"] == "v2"
            np.testing.assert_array_equal(cli.embed(q),
                                          v2.embeddings[[0, 5, 2999]])
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() <= before
            assert srv.bundle_version == "v2"
            assert max(srv.padded_shapes_seen().values()) <= len(srv.ladder)
    finally:
        srv.stop()


# -- slice 7: the alias and fused layouts, the activation cache -------------

def _weighted_tables(dev, n=3000, cap=16, seed=8):
    """A seeded weighted table (random weights, some zero, hubs above
    the cap) in the split layout with the alias words, and its fused
    table, on `dev`."""
    from euler_tpu_torch.parallel.device_sampler import (
        DeviceNeighborTable, fuse_tables_host,
    )

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * cap, n)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nbrs = rng.integers(0, n, offsets[-1]).astype(np.int32)
    ws = rng.uniform(0.0, 3.0, len(nbrs)).astype(np.float32)
    ws[rng.random(len(nbrs)) < 0.1] = 0.0
    tab = DeviceNeighborTable.from_csr(offsets, nbrs, ws, cap=cap,
                                       device="cpu", keep_host=True,
                                       alias=True)
    nbr, cum = tab.host_tables
    out = {"nbr_table": tab.neighbors, "cum_table": tab.cum_weights,
           "alias_table": tab.alias_table,
           "nbrcum_table": torch.from_numpy(fuse_tables_host(nbr, cum))}
    return {k: v.to(dev) for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 4, 15])
def test_cuda_alias_and_fused_draws_match_the_cpu(count):
    """The same uniforms through the alias draw and the fused draw on the
    card and on the CPU: the same picks, bit for bit; the fused picks
    equal the split tables' weighted picks."""
    _need_card()
    from euler_tpu_torch.parallel.device_sampler import (
        sample_hop, sample_hop_fused,
    )

    cpu = _weighted_tables("cpu")
    card = {k: v.cuda() for k, v in cpu.items()}
    n = cpu["nbr_table"].shape[0]
    rows = torch.arange(n, dtype=torch.int32).repeat(3)
    u = torch.rand((2, rows.shape[0], count),
                   generator=torch.Generator().manual_seed(count))
    got = {}
    for name, t in (("cpu", cpu), ("card", card)):
        r, uu = rows.to(t["nbr_table"].device), u.to(t["nbr_table"].device)
        got[name] = (
            sample_hop(t["nbr_table"], t["cum_table"], r, count,
                       uniforms=uu, alias_table=t["alias_table"]).cpu(),
            sample_hop_fused(t["nbrcum_table"], r, count,
                             uniforms=uu[0]).cpu(),
            sample_hop(t["nbr_table"], t["cum_table"], r, count,
                       uniforms=uu[0]).cpu())
    for a, b in zip(got["cpu"], got["card"]):
        assert torch.equal(a, b)
    assert torch.equal(got["card"][1], got["card"][2])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15])
def test_cuda_kernel_bf16_table_f32_out_matches_plain(k):
    """A bfloat16 table (the activation cache) read with a float32
    output: the kernel against its plain version (float32 within 1e-5
    of the largest), one launch."""
    _need_card()
    rng = np.random.default_rng(9)
    t, _ = _table("bf16", 20_000, 128, rng)
    r = torch.from_numpy(rng.integers(0, 20_000, (4096, k)).astype(
        np.int32)).cuda()
    before = gather_mean.launches
    got = gather_mean(t, r, out_dtype=torch.float32)
    assert gather_mean.launches == before + 1
    assert got.dtype == torch.float32
    _assert_matches_plain(got, gather_mean_reference(
        t.cpu(), r.cpu(), out_dtype=torch.float32))


def _cache_estimator(setup, dev="cuda", **cfg):
    """The cora setup with DeviceSampledScalableSage (one hop of 10, 2
    layers, a bfloat16 cache) in place of the fanout model."""
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.models.graphsage import DeviceSampledScalableSage

    store, tab, graph, _, params = setup
    model = DeviceSampledScalableSage(
        7, 1433, multilabel=False, dim=64, fanout=10, num_layers=2,
        max_id=tab.pad_row, cache_dtype=torch.bfloat16, dropout=0.6,
        uniform_sampling=tab.uniform_rows,
        generator=torch.Generator().manual_seed(0))
    return NodeEstimator(model, {**params, "checkpoint_steps": 0,
                                 "log_steps": 1 << 30, **cfg},
                         graph, None, feature_store=store,
                         device_sampler=tab, device=dev)


@pytest.mark.cuda
def test_cuda_act_cache_graph_matches_eager_and_skips_nonfinite():
    """The activation cache at K = 4: graph windows against eager steps
    bit for bit, the bfloat16 cache included (its deduplicated writes
    and the gradient through them), 2 gather_mean kernels a step in the
    graph; a window whose every step is NaN leaves the cache, the
    parameters and Adam as they were."""
    _need_card()
    setup = _training_setup("cora")
    store = setup[0]
    feed = _cache_estimator(setup).train_input_fn()
    raw = [next(feed) for _ in range(14)]
    graphed = _cache_estimator(setup, steps_per_loop=4)
    eager = _cache_estimator(setup)
    rg = graphed.train(iter(raw), max_steps=14)
    re_ = eager.train(iter(raw), max_steps=14)
    assert graphed._graphed.launches_per_replay == 8
    assert rg["losses"] == re_["losses"]
    _assert_same_state(graphed, eager)
    h = graphed.model.encoder.cache_1.h
    assert h.dtype == torch.bfloat16 and h.float().abs().sum() > 0
    bad = _labelled([next(feed) for _ in range(4)], store,
                    nan_at={0, 1, 2, 3})
    graphed.train(iter(_labelled(raw[:4], store)), max_steps=18)
    before = {k: v.clone() for k, v in graphed.model.state_dict().items()}
    res = graphed.train(iter(bad), max_steps=22)
    assert res["skipped_steps"] == 4
    for k, v in graphed.model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "alias"])
def test_cuda_layout_graph_windows_match_eager_steps(layout):
    """The cora setup over the fused table or with the alias table at
    K = 4: graph windows against eager steps, bit for bit."""
    _need_card()
    from euler_tpu_torch.parallel.device_sampler import (
        build_alias_tables, fuse_tables_host,
    )

    setup = _training_setup("cora")
    tab = setup[1]
    nbr, cum = tab.neighbors.cpu().numpy(), tab.cum_weights.cpu().numpy()
    tables = ({"nbrcum_table": torch.from_numpy(
        fuse_tables_host(nbr, cum)).cuda()} if layout == "fused" else
        {"alias_table": torch.from_numpy(
            build_alias_tables(nbr, cum_tab=cum)).cuda()})

    def est(**cfg):
        e = _estimator(setup, **cfg)
        if layout == "fused":
            e.static_batch.pop("nbr_table")
            e.static_batch.pop("cum_table")
        e.static_batch.update(tables)
        return e

    feed = est().train_input_fn()
    batches = [next(feed) for _ in range(12)]
    graphed, eager = est(steps_per_loop=4), est()
    rg = graphed.train(iter(batches), max_steps=12)
    re_ = eager.train(iter(batches), max_steps=12)
    assert graphed._graphed.launches_per_replay == 4
    assert rg["losses"] == re_["losses"]
    _assert_same_state(graphed, eager)


# -- the engine-built tables and the host-fed path ---------------------------

@pytest.mark.cuda
def test_cuda_engine_tables_equal_their_from_arrays_twins():
    """DeviceNeighborTable(graph) in the split, fused and alias layouts
    and DeviceFeatureStore(graph) (int8 with a float32 scale, and
    bfloat16) on the card, built from a 20,000-node products-like graph
    in the engine, equal their twins from the same arrays (from_csr,
    from_arrays) and the same engine build on the CPU, byte for byte."""
    _need_card()
    from euler_tpu_torch.dataset import engine_from_arrays
    from euler_tpu_torch.dataset.synthetic import products_like
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    g = products_like(20_000, 50, 100, 16)
    graph = engine_from_arrays(g).engine
    for kw in ({}, {"fused": True}, {"alias": True}):
        got = DeviceNeighborTable(graph, cap=32, device="cuda", **kw)
        want = DeviceNeighborTable.from_csr(g.offsets, g.neighbors, cap=32,
                                            device="cuda", **kw)
        assert got.tables.keys() == want.tables.keys()
        for k, t in got.tables.items():
            assert t.is_cuda and torch.equal(t, want.tables[k]), (kw, k)
    feats = np.concatenate([g.features, np.zeros((1, 100), np.float32)])
    labels = np.concatenate([g.onehot_labels(),
                             np.zeros((1, 16), np.float32)])
    got = DeviceFeatureStore(graph, ["feature"], label_fid="label",
                             label_dim=16, quantize="int8", device="cuda")
    want = DeviceFeatureStore.from_arrays(feats, labels, quantize="int8",
                                          device="cuda")
    for a, b in ((got.features, want.features),
                 (got.feature_scale, want.feature_scale),
                 (got.labels, want.labels)):
        assert a.is_cuda and torch.equal(a, b)
    for quantize in ("int8", None):
        kw = dict(label_fid="label", label_dim=16, dtype=torch.bfloat16,
                  quantize=quantize)
        card = DeviceFeatureStore(graph, ["feature"], device="cuda", **kw)
        cpu = DeviceFeatureStore(graph, ["feature"], device="cpu", **kw)
        assert torch.equal(card.features.cpu(), cpu.features)
    np.testing.assert_array_equal(
        got.lookup(np.array([0, 7, 19_999, 1 << 40], np.uint64)),
        [0, 7, 19_999, 20_000])


def _host_fed_step(dev, mode):
    """One NodeEstimator step of SupervisedGraphSage (fanouts [10, 5],
    dim 32, 1433 int8 features with a float32 scale on the "rows" path,
    float32 "layers" on the host-arrays path) on the cora stand-in's
    engine, the engine seeded to 0: (loss, metric, parameters)."""
    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.dataset import get_dataset
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.graph import seed
    from euler_tpu_torch.models.graphsage import SupervisedGraphSage
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    data = get_dataset("cora")
    g = data.engine
    store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                               label_dim=7, quantize="int8",
                               device=dev) if mode == "rows" else None
    flow = FanoutDataFlow(g, [10, 5], feature_ids=["feature"],
                          with_features=mode == "layers")
    model = SupervisedGraphSage(7, 1433, multilabel=False, dim=32,
                                fanouts=(10, 5),
                                generator=torch.Generator().manual_seed(0))
    est = NodeEstimator(model, {"batch_size": 256, "checkpoint_steps": 0,
                                "log_steps": 1 << 30}, g, flow,
                        label_dim=7, feature_store=store, device=dev)
    seed(0)
    res = est.train(est.train_input_fn, max_steps=1)
    return res, {k: (p.detach().cpu(), p.grad.cpu())
                 for k, p in est.model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rows", "layers"])
def test_cuda_host_fed_step_matches_the_cpu(mode):
    """A host-fed SupervisedGraphSage step (bench.py --host_sampler's
    rows into the int8 table, or the host's feature layers) on the card
    against the same step on the CPU, the same engine draws (float32,
    TF32 off): the loss and metric within rtol 1e-4, the gradients
    within atol 1e-5 of the largest, the updated parameters within atol
    1e-5 where the gradient exceeds 1e-6. Adam's first step moves a
    parameter by lr·g/(|g| + 1e-8), so where |g| is near Adam's eps the
    two devices' last-bit differences in g move it anywhere within lr;
    there the bound is lr (0.01, the step's largest move)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    card, p_card = _host_fed_step("cuda", mode)
    cpu, p_cpu = _host_fed_step("cpu", mode)
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-4)
    assert card["metric"] == pytest.approx(cpu["metric"], rel=1e-4)
    for k, (v, g) in p_cpu.items():
        v_card, g_card = p_card[k]
        torch.testing.assert_close(g_card, g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()))
        tol = torch.where(g.abs() > 1e-6, 1e-5, 0.01)
        assert bool(((v_card - v).abs() <= tol).all()), k


@pytest.mark.cuda
def test_cuda_flagship_step_over_engine_tables_launches_gather_mean():
    """The flagship setup over tables built from the engine: one
    training step launches the gather_mean kernel once, its batch roots
    drawn by the engine's sample_node."""
    _need_card()
    from euler_tpu_torch.ops.gather_mean import gather_mean

    est = _estimator(_training_setup("flagship"))
    before = gather_mean.launches
    res = est.train(est.train_input_fn, max_steps=1)
    torch.cuda.synchronize()
    assert gather_mean.launches == before + 1
    assert np.isfinite(res["loss"])


# -- slice 9: the layerwise family and the conv stacks ------------------------

def _layerwise_estimator(setup, dev="cuda", alias=None, **cfg):
    """DeviceSampledLayerwiseGCN (dim 32, pools (64, 64), layer dropout
    0.5) on the cora setup's tables (int8 features with a float32
    scale), batch 64, Adam lr 0.01; alias: an alias table placed beside
    the split tables."""
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.models.graphsage import DeviceSampledLayerwiseGCN

    store, tab, graph, _, _ = setup
    model = DeviceSampledLayerwiseGCN(
        7, 1433, multilabel=False, dim=32, layer_sizes=(64, 64),
        layer_dropout=0.5, generator=torch.Generator().manual_seed(0))
    est = NodeEstimator(model, {"batch_size": 64, "learning_rate": 0.01,
                                "checkpoint_steps": 0,
                                "log_steps": 1 << 30, **cfg},
                        graph, None, feature_store=store,
                        device_sampler=tab, device=dev)
    if alias is not None:
        est.static_batch["alias_table"] = alias
    return est


def _alias_of(tab, dev):
    from euler_tpu_torch.parallel.device_sampler import build_alias_tables

    return torch.from_numpy(build_alias_tables(
        tab.neighbors.cpu().numpy(),
        cum_tab=tab.cum_weights.cpu().numpy())).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "alias"])
def test_cuda_layerwise_step_matches_the_cpu(layout):
    """One DeviceSampledLayerwiseGCN step on the card against the same
    step on the CPU, the same roots and replayed uniforms ([m] or
    [3, m] a layer), eval mode (no dropout), TF32 off: the levels equal,
    the adjacencies within 1e-6, the loss within rtol 1e-4 and the
    gradients within atol 1e-5 of the largest (the adjacency's
    row sums and the GEMMs add in another order on the card)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    roots = rng.integers(0, 2708, 64).astype(np.int32)
    shape = (lambda m: (m,)) if layout == "split" else (lambda m: (3, m))
    uniforms = [rng.random(shape(64), dtype=np.float32) for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        setup = _training_setup("cora", dev=dev)
        est = _layerwise_estimator(
            setup, dev=dev, alias=_alias_of(setup[1], dev)
            if layout == "alias" else None)
        model = est.model.eval()
        batch = {"rows": [torch.from_numpy(roots).to(dev)],
                 "sample_uniforms": [torch.from_numpy(u).to(dev)
                                     for u in uniforms],
                 **est.static_batch}
        levels, adjs = model.sample_levels(batch)
        res = model(batch)
        res.loss.backward()
        out[dev] = ([x.cpu() for x in levels], [a.cpu() for a in adjs],
                    float(res.loss.detach()), {k: p.grad.cpu() for k, p in
                                      model.named_parameters()})
    (lc, ac, loss_c, gc), (lp, ap, loss_p, gp) = out["cuda"], out["cpu"]
    for a, b in zip(lc, lp):
        assert torch.equal(a, b)
    for a, b in zip(ac, ap):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert loss_c == pytest.approx(loss_p, rel=1e-4)
    for k, g in gp.items():
        torch.testing.assert_close(gc[k], g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "alias"])
def test_cuda_layerwise_graph_windows_match_eager_steps(layout):
    """DeviceSampledLayerwiseGCN at K = 4 (its stream word 31 re-seeded
    per replay, dropout generators too) against eager steps on the same
    batches: the same losses, parameters and Adam moments, bit for bit;
    no gather_mean kernel in the graph. An evaluate() over host closure
    batches after it neither captures nor replays."""
    _need_card()
    from euler_tpu_torch.dataflow import LayerwiseDataFlow

    setup = _training_setup("cora")
    alias = _alias_of(setup[1], "cuda") if layout == "alias" else None
    feed = _layerwise_estimator(setup).train_input_fn()
    batches = [next(feed) for _ in range(10)]
    graphed = _layerwise_estimator(setup, alias=alias, steps_per_loop=4)
    eager = _layerwise_estimator(setup, alias=alias)
    rg = graphed.train(iter(batches), max_steps=10)
    re_ = eager.train(iter(batches), max_steps=10)
    loop = graphed._graphed
    assert (loop.captures, loop.replays, loop.launches_per_replay) == \
        (1, 1, 0)
    assert rg["losses"] == re_["losses"]
    _assert_same_state(graphed, eager)
    flow = LayerwiseDataFlow(setup[2], [64, 64], sample=False,
                             feature_ids=["feature"])
    graphed.eval_via_flow, graphed.eval_dataflow = True, flow
    res = graphed.evaluate(graphed.eval_sweep_input_fn(), 2)
    assert np.isfinite(res["loss"])
    assert (loop.captures, loop.replays) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["gcn", "gat"])
def test_cuda_conv_step_matches_the_cpu(conv):
    """One NodeEstimator step of the gcn or gat (8 heads) citation model
    over FullBatchDataFlow on the cora stand-in, on the card against the
    CPU, the same engine draws and no dropout, TF32 off: the loss within
    rtol 1e-4, the gradients within atol 1e-5 of the largest (the card's
    index_add adds with atomics, in another order)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from euler_tpu_torch.dataset import get_dataset
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.examples.common import ConvModel, full_batch_flow
    from euler_tpu_torch.graph import seed

    data = get_dataset("cora")
    out = {}
    for dev in ("cuda", "cpu"):
        model = ConvModel(7, 1433, conv, dim=16 if conv == "gat" else 32,
                          conv_kwargs={"heads": 8},
                          generator=torch.Generator().manual_seed(0))
        est = NodeEstimator(model, {"batch_size": 128,
                                    "checkpoint_steps": 0,
                                    "log_steps": 1 << 30},
                            data.engine, full_batch_flow(data),
                            label_dim=7, device=dev)
        seed(0)
        res = est.train(est.train_input_fn, max_steps=1)
        out[dev] = (res["loss"], {k: p.grad.cpu() for k, p in
                                  est.model.named_parameters()})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert lc == pytest.approx(lp, rel=1e-4)
    for k, g in gp.items():
        torch.testing.assert_close(gc[k], g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("runner", ["run_gat", "run_dna"])
def test_cuda_conv_runner_repeats_bit_for_bit(runner):
    """A citation runner with dropout (GAT's attention sums, DNA's
    per-edge means) for 20 steps twice on the card with the same seed:
    the same result dict, bit for bit (mp_ops' sums on CUDA are sorted
    segment sums, not atomics)."""
    _need_card()
    import importlib

    mod = importlib.import_module(f"euler_tpu_torch.examples.{runner}")
    runs = [{k: v for k, v in mod.main(["--max_steps", "20", "--seed",
                                       "1"]).items()
             if k != "train_steps_per_sec"} for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_mp_ops_out_of_range_indices():
    """mp_ops on the card with the reference's out-of-range case (src =
    arange(12).reshape(4, 3), segment ids [0, 1, -1, 3] over 3, gather
    rows [-1, 5]): the values jnp.take's fill mode and
    jax.ops.segment_sum / segment_max give, which the CPU path gives
    too; scatter_softmax's in-range entries equal the CPU's."""
    _need_card()
    from euler_tpu_torch.ops import mp_ops as mp

    nan = float("nan")
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    index = torch.tensor([0, 1, -1, 3], dtype=torch.int32)
    rows = torch.tensor([-1, 5], dtype=torch.int32)
    summed = torch.tensor([[0., 1, 2], [3, 4, 5], [0, 0, 0]])
    want = {"gather": torch.tensor([[9., 10, 11], [nan, nan, nan]]),
            "scatter_add": summed, "scatter_max": summed,
            "scatter_mean": summed,
            "segment_count": torch.tensor([1., 1, 0])}
    for dev in ("cuda", "cpu"):
        s, i, r = src.to(dev), index.to(dev), rows.to(dev)
        got = {"gather": mp.gather(s, r),
               "scatter_add": mp.scatter_add(s, i, 3),
               "scatter_max": mp.scatter_max(s, i, 3),
               "scatter_mean": mp.scatter_mean(s, i, 3),
               "segment_count": mp.segment_count(i, 3)}
        for k, v in want.items():
            torch.testing.assert_close(got[k].cpu(), v, rtol=0, atol=0,
                                       equal_nan=True)
    soft = [mp.scatter_softmax(src[:, 0].to(d), index.to(d), 3).cpu()
            for d in ("cuda", "cpu")]
    torch.testing.assert_close(soft[0][:2], soft[1][:2], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["set2set", "attention"])
def test_cuda_graph_model_step_matches_the_cpu(pool):
    """One GraphEstimator step of GraphModel (gin + set2set, gated +
    attention, the mutag runners' widths) on the same packed batch, on
    the card against the CPU, no dropout, TF32 off: the loss within
    rtol 1e-4, the gradients within 1e-5 of the largest."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from euler_tpu_torch.dataset import get_dataset
    from euler_tpu_torch.estimator.estimators import GraphEstimator
    from euler_tpu_torch.mp_utils.graph_gnn import GraphModel

    data = get_dataset("mutag")
    conv = "gin" if pool == "set2set" else "gated"
    out = {}
    for dev in ("cuda", "cpu"):
        model = GraphModel(data.feature_dim, conv, pool, 32, 2, 16, 2,
                           generator=torch.Generator().manual_seed(0))
        est = GraphEstimator(model, {"num_graphs": 16, "seed": 3,
                                     "checkpoint_steps": 0,
                                     "log_steps": 1 << 30},
                             data.graphs, data.labels, device=dev)
        res = est.train(est.train_input_fn, max_steps=1)
        out[dev] = (res["loss"], {k: p.grad.cpu() for k, p in
                                  est.model.named_parameters()})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert lc == pytest.approx(lp, rel=1e-4)
    top = max(float(g.abs().max()) for g in gp.values())
    for k, g in gp.items():
        torch.testing.assert_close(gc[k], g, rtol=0, atol=1e-5 * top)


@pytest.mark.cuda
def test_cuda_gin_runner_repeats_bit_for_bit():
    """run_gin (dropout 0.5 on the readout) for 30 steps twice on the
    card with the same seed: the same result dict, bit for bit."""
    _need_card()
    from euler_tpu_torch.examples import run_gin

    runs = [{k: v for k, v in run_gin.main(["--max_steps", "30", "--seed",
                                            "2"]).items()
             if k != "train_steps_per_sec"} for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_lgcn_runner_repeats_bit_for_bit():
    """run_lgcn (dropout 0.5, the top-k Conv1d over host fanouts) for 30
    steps twice on the card with the same seed: the same result dict,
    bit for bit."""
    _need_card()
    from euler_tpu_torch.examples import run_lgcn

    runs = [{k: v for k, v in run_lgcn.main(["--max_steps", "30", "--seed",
                                             "2"]).items()
             if k != "train_steps_per_sec"} for _ in range(2)]
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_kernel_f32_cache_read_matches_plain():
    """The host-fed ScalableGraphSage's layer-1 read at run_scalable_sage's
    defaults: a float32 cache [2708, 32] (max_id + 1 rows of cora), 64
    roots x 10 neighbor rows, float32 out; the kernel against the plain
    version, one launch."""
    _need_card()
    rng = np.random.default_rng(11)
    table = torch.from_numpy(
        rng.normal(size=(2708, 32)).astype(np.float32)).cuda()
    rows = torch.from_numpy(
        rng.integers(0, 2708, (64, 10)).astype(np.int32)).cuda()
    before = gather_mean.launches
    got = gather_mean(table, rows)
    torch.cuda.synchronize()
    assert gather_mean.launches == before + 1
    _assert_matches_plain(got, gather_mean_reference(table, rows))


def _kg_step(model, batch, dev):
    """One forward and backward: (loss, {name: gradient on the host}),
    a row-sparse table gradient (an Embedding on the card) in its dense
    form."""
    from euler_tpu_torch.ops.row_sparse_adam import densify

    model = model.to(dev)
    out = model({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    out.loss.backward()
    return float(out.loss), {k: densify(p.grad).cpu()
                             for k, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TransE", "RGCNLinkModel"])
def test_cuda_kg_models_match_the_cpu(name):
    """TransE (dim 64, 16 negatives) and the R-GCN runner's model (dim 32,
    8 relations x fanout 8) at the fb15k237 stand-in's table sizes, one
    step from the same weights and batch on the card and on the CPU: the
    loss within rtol 1e-4, every gradient within 1e-5 of the largest."""
    _need_card()
    from euler_tpu_torch.examples.run_rgcn import RGCNLinkModel
    from euler_tpu_torch.models.kg_models import TransE

    rng = np.random.default_rng(12)
    ent, rel, b = 14541, 237, 256
    batch = {"h": rng.integers(0, ent, b), "t": rng.integers(0, ent, b),
             "r": rng.integers(0, rel, b).astype(np.int32),
             "neg_t": rng.integers(0, ent, (b, 16))}

    def make():
        g = torch.Generator().manual_seed(0)
        if name == "TransE":
            return TransE(ent, rel, dim=64, generator=g)
        return RGCNLinkModel(ent, rel, 32, 8, generator=g)

    if name == "RGCNLinkModel":
        batch["h_nbrs"] = rng.integers(0, ent, (8, b, 8))
    lc, gc = _kg_step(make(), batch, "cpu")
    lg, gg = _kg_step(make(), batch, "cuda")
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    top = max(float(v.abs().max()) for v in gc.values())
    for k, v in gc.items():
        assert float((gg[k] - v).abs().max()) <= 1e-5 * top


@pytest.mark.cuda
def test_cuda_transe_runner_repeats_bit_for_bit():
    """run_transx (TransE) for 30 steps twice on the card with the same
    seed: the same result dict, bit for bit."""
    _need_card()
    from euler_tpu_torch.examples import run_transx

    runs = [{k: v for k, v in run_transx.main(
        ["--max_steps", "30", "--eval_steps", "5", "--seed", "3"]).items()
        if k != "train_steps_per_sec"} for _ in range(2)]
    assert runs[0] == runs[1]


# -- slice 12: graphs that change ---------------------------------------------

@pytest.mark.cuda
def test_cuda_patch_rows_binds_new_tensors_and_the_loop_recaptures():
    """The cora setup at K = 8 over a table kept on the host too: after
    an edge-only delta of 64 edges, patch_rows scatters into new tensors
    on the card ("row_scatter") equal to the host copies and to a build
    from scratch; the estimator's captured graph goes on reading the old
    tensors (a window replays, no capture); merging the new ones makes
    the loop capture again. On the patched table K = 8 equals K = 1 bit
    for bit."""
    _need_card()
    from euler_tpu_torch.graph import delta_dirty_ids
    from euler_tpu_torch.parallel.device_sampler import DeviceNeighborTable

    store, _, graph, model, params = _training_setup("cora")
    tab = DeviceNeighborTable(graph, cap=32, keep_host=True, device="cuda")
    setup = (store, tab, graph, model, params)
    k = 8
    feed = _estimator(setup).train_input_fn()
    batches = [next(feed) for _ in range(8 * k)]
    est = _estimator(setup, steps_per_loop=k)
    est.train(iter(batches[:k]), max_steps=k)
    loop = est._graphed
    assert (loop.captures, loop.replays) == (1, 0)
    old = est.static_batch["nbr_table"]
    rng = np.random.default_rng(11)
    ids = graph.all_node_ids()
    delta = {"edge_src": rng.choice(ids, 64), "edge_dst": rng.choice(ids, 64),
             "edge_weights": np.ones(64, np.float32)}
    graph.apply_delta(**delta)
    stats = tab.patch_rows(graph, delta_dirty_ids(**delta))
    assert stats["upload"] == "row_scatter" and stats["rows_patched"] > 0
    assert tab.neighbors is not old
    assert tab.neighbors.data_ptr() != old.data_ptr()
    scratch = DeviceNeighborTable(graph, cap=32, device="cpu")
    for dev_t, host, fresh in ((tab.neighbors, tab.host_tables[0],
                                scratch.neighbors),
                               (tab.cum_weights, tab.host_tables[1],
                                scratch.cum_weights)):
        got = dev_t.cpu().numpy()
        assert got.tobytes() == host.tobytes() == fresh.numpy().tobytes()
    est.train(iter(batches[k:2 * k]), max_steps=2 * k)
    assert (loop.captures, loop.replays) == (1, 1)
    assert est.static_batch["nbr_table"] is old
    est.static_batch.update(tab.tables)
    est.train(iter(batches[2 * k:4 * k]), max_steps=4 * k)
    assert (loop.captures, loop.replays) == (2, 2)
    graphed = _estimator(setup, steps_per_loop=k)
    eager = _estimator(setup)
    assert graphed.static_batch["nbr_table"] is tab.neighbors
    rest = batches[4 * k:]
    rg = graphed.train(iter(rest), max_steps=len(rest))
    re_ = eager.train(iter(rest), max_steps=len(rest))
    assert rg["losses"] == re_["losses"]
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
def test_cuda_host_fed_line_graph_windows_match_eager_steps():
    """run_line's host-fed LINE at steps_per_loop = 8 (the ml_1m quality
    gate's form: host batches copied into the graph's inputs, one replay
    per 8 steps) against K = 1 on the same engine batches: the same
    losses, parameters and Adam moments, bit for bit."""
    _need_card()
    from euler_tpu_torch.dataset import get_dataset
    from euler_tpu_torch.estimator.base_estimator import BaseEstimator
    from euler_tpu_torch.models.embedding_models import LINE

    data = get_dataset("ml_1m", num_users=300, num_items=120,
                       num_ratings=6000)
    g = data.engine
    batches = []
    for _ in range(3 * 8 + 2):
        src, dst, _ = g.sample_edge(128, -1)
        negs = g.sample_node(128 * 5, -1).reshape(128, 5)
        batches.append({"src": src, "pos": dst, "negs": negs,
                        "infer_ids": src})

    def est(k):
        return BaseEstimator(
            LINE(data.max_id, dim=32, generator=torch.Generator()
                 .manual_seed(0)),
            {"learning_rate": 0.025, "max_id": data.max_id,
             "steps_per_loop": k, "checkpoint_steps": 0,
             "log_steps": 1 << 30}, device="cuda")

    graphed, eager = est(8), est(1)
    rg = graphed.train(iter(batches), max_steps=len(batches))
    re_ = eager.train(iter(batches), max_steps=len(batches))
    assert (graphed._graphed.captures, graphed._graphed.replays) == (1, 2)
    assert rg["losses"] == re_["losses"]
    assert np.isfinite(rg["losses"]).all()
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
def test_cuda_host_fed_steps_from_a_two_shard_cluster(tmp_path):
    """The cora stand-in's engine dumped as 2 partitions and served by 2
    shards found through a tcp: registry (gql.start_registry); a
    RemoteGraphEngine under a CachedGraphEngine feeds 3 host-fed
    SupervisedGraphSage steps on the card (rows into the int8 table
    through the embedded engine's lookup): finite losses, a falling
    loss on one held batch drawn from the cluster (the steps' own
    batches are the shards' draws, which no seed repeats, so their
    losses need not fall step to step), no skipped step, no degraded
    batch and no gather_mean launch (the path takes no kernel of the
    port); the shards and the registry are stopped and their ports
    released."""
    _need_card()
    import socket

    from euler_tpu_torch import gql
    from euler_tpu_torch.dataflow import FanoutDataFlow
    from euler_tpu_torch.dataset import get_dataset
    from euler_tpu_torch.estimator.base_estimator import _to_device
    from euler_tpu_torch.estimator.estimators import NodeEstimator
    from euler_tpu_torch.graph import CachedGraphEngine, RemoteGraphEngine
    from euler_tpu_torch.models.graphsage import SupervisedGraphSage
    from euler_tpu_torch.parallel.feature_store import DeviceFeatureStore

    g = get_dataset("cora").engine
    d = str(tmp_path / "g")
    g.dump(d, num_partitions=2)
    reg = gql.start_registry()
    spec = f"tcp:127.0.0.1:{reg.port}"
    shards = [gql.start_service(d, shard_idx=i, shard_num=2,
                                registry_dir=spec) for i in range(2)]
    remote = RemoteGraphEngine(spec, seed=3, pool_size=2)
    try:
        cached = CachedGraphEngine(remote)
        store = DeviceFeatureStore(g, ["feature"], label_fid="label",
                                   label_dim=7, quantize="int8",
                                   device="cuda")
        model = SupervisedGraphSage(
            7, 1433, multilabel=False, dim=32, fanouts=(10, 5),
            generator=torch.Generator().manual_seed(0))
        est = NodeEstimator(
            model, {"batch_size": 256, "learning_rate": 0.01,
                    "checkpoint_steps": 0, "log_steps": 1 << 30},
            cached, FanoutDataFlow(cached, [10, 5], with_features=False),
            label_dim=7, feature_store=store, device="cuda")
        held = _to_device(next(est.train_input_fn()), est.device)

        def held_loss():
            est.model.eval()
            with torch.no_grad():
                return float(est.model({**held, **est.static_batch}).loss)

        gather_mean.launches = 0
        before = held_loss()
        res = est.train(est.train_input_fn, max_steps=3)
        losses = res["losses"]
        assert len(losses) == 3 and np.isfinite(losses).all()
        assert held_loss() < before
        assert int(est.skipped_steps) == 0
        assert gather_mean.launches == 0
        assert remote.health()["degraded"] == 0
    finally:
        remote.close()
        ports = [s.port for s in shards]
        for s in shards:
            s.stop()
        reg.stop()
    for port in ports:
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
