"""gather_mean of the PyTorch port against the JAX package's
(euler_tpu/ops/pallas_ops.py), on the CPU. The CUDA kernel against its
plain version is in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas_ops import _pallas_gather_mean, _xla_gather_mean
from euler_tpu.parallel.feature_store import dequantize_rows, quantize_int8
from euler_tpu_torch.ops.gather_mean import gather_mean, gather_mean_reference


def _inputs(seed=0, n_table=300, d=16, n=16, k=4):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_table, d)).astype(np.float32)
    rows = rng.integers(0, n_table, (n, k)).astype(np.int32)
    return table, rows


@pytest.mark.parametrize("shape", [(64, 128, 16, 5), (300, 16, 16, 4)])
def test_f32_matches_xla_and_pallas_interpret(shape):
    n_table, d, n, k = shape
    table, rows = _inputs(1, n_table, d, n, k)
    ref_xla = np.asarray(_xla_gather_mean(jnp.asarray(table),
                                          jnp.asarray(rows)))
    ref_pallas = np.asarray(_pallas_gather_mean(
        jnp.asarray(table), jnp.asarray(rows), interpret=True))
    t, r = torch.from_numpy(table), torch.from_numpy(rows)
    for got in (gather_mean(t, r), gather_mean_reference(t, r)):
        assert got.dtype == torch.float32 and got.shape == (n, d)
        np.testing.assert_allclose(got.numpy(), ref_xla, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), ref_pallas, atol=1e-6)


def test_bf16_table_keeps_dtype():
    table, rows = _inputs(2)
    t = torch.from_numpy(table).to(torch.bfloat16)
    got = gather_mean(t, torch.from_numpy(rows))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(_xla_gather_mean(jnp.asarray(t.float().numpy()),
                                      jnp.asarray(rows)))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_int8_fused_dequant_matches_jax(scale_dtype):
    table, rows = _inputs(3)
    q, scale = quantize_int8(table)
    jscale = jnp.asarray(scale).astype(getattr(jnp, scale_dtype))
    ref = np.asarray(dequantize_rows(jnp.take(jnp.asarray(q),
                                              jnp.asarray(rows), axis=0),
                                     jscale).mean(axis=1)).astype(np.float32)
    tscale = torch.from_numpy(scale).to(getattr(torch, scale_dtype))
    got = gather_mean(torch.from_numpy(q), torch.from_numpy(rows), tscale)
    assert got.dtype == tscale.dtype
    smax = float(np.abs(scale).max())
    if scale_dtype == "float32":
        # f32 sums of int8 are exact; the two differ only in where the
        # scale multiply rounds
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * 127 * smax)
    else:
        # one bf16 rounding of the output vs the reference's per-row
        # rounding: one bf16 ulp of the largest dequantized value
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                                   atol=2 ** -7 * 127 * smax)


def test_cpu_call_launches_nothing():
    table, rows = _inputs(4)
    before = gather_mean.launches
    gather_mean(torch.from_numpy(table), torch.from_numpy(rows))
    assert gather_mean.launches == before


@pytest.mark.parametrize("case", [
    "rows_int64", "rows_1d", "k_zero", "int8_no_scale", "f32_with_scale",
    "scale_f16", "scale_shape", "table_f16", "table_grad",
    "non_contiguous"])
def test_bad_inputs_raise(case):
    table, rows = _inputs(5)
    t, r = torch.from_numpy(table), torch.from_numpy(rows)
    q = torch.from_numpy(quantize_int8(table)[0])
    s = torch.ones(table.shape[1])
    args = {
        "rows_int64": (t, r.long(), None),
        "rows_1d": (t, r[:, 0].contiguous(), None),
        "k_zero": (t, r[:, :0].contiguous(), None),
        "int8_no_scale": (q, r, None),
        "f32_with_scale": (t, r, s),
        "scale_f16": (q, r, s.half()),
        "scale_shape": (q, r, s[:-1]),
        "table_f16": (t.half(), r, None),
        "table_grad": (t.clone().requires_grad_(True), r, None),
        "non_contiguous": (t.t(), r, None),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        gather_mean(*args)
    with pytest.raises((TypeError, ValueError)):
        gather_mean_reference(*args)
