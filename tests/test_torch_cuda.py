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
