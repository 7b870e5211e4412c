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
