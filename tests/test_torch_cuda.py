"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc (marked
`cuda`; they skip without a card). This file imports no JAX, so it runs
on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from euler_tpu_torch.ops.gather_mean import gather_mean, gather_mean_reference
from euler_tpu_torch.parallel.feature_store import quantize_int8


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
    bad[1, 3] = t.shape[0]  # out of range: that output row is NaN
    out = gather_mean(t, bad, s)
    assert torch.isnan(out[1].float()).all()
    assert torch.isfinite(out[0].float()).all()


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
