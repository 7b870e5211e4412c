"""gather_mean of the PyTorch port against the JAX package's
(euler_tpu/ops/pallas_ops.py), on the CPU: values, jnp.take's wrap/fill
rule for out-of-range rows, and the kernel's launch plan. The CUDA kernel
against its plain version is in test_torch_cuda.py."""

import euler_tpu_torch  # noqa: F401 (first: OMP_WAIT_POLICY)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.models.graphsage import \
    gather_feature_rows as jax_gather_feature_rows
from euler_tpu.ops.pallas_ops import _pallas_gather_mean, _xla_gather_mean
from euler_tpu.ops.pallas_ops import gather_mean as jax_gather_mean
from euler_tpu.parallel.feature_store import dequantize_rows, quantize_int8
from euler_tpu_torch.models.graphsage import gather_feature_rows
from euler_tpu_torch.ops.gather_mean import (
    gather_mean, gather_mean_reference, launch_plan, take_rows,
)


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


# --- out-of-range rows: jnp.take's default mode="fill" -----------------

N_TABLE = 40
# wrap: -1, -N; fill: N, N + 5, -N - 1
EDGE_ROWS = (-1, -N_TABLE, N_TABLE, N_TABLE + 5, -N_TABLE - 1)
CASES = ["f32", "bf16", "int8_f32", "int8_bf16"]


def _edge_case(case, seed=11, d=16, n=12, k=5):
    """A table of `case` (numpy arrays for JAX, tensors for the port) and
    rows [n, k] holding every wrap/fill index."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N_TABLE, d)).astype(np.float32)
    rows = rng.integers(0, N_TABLE, (n, k)).astype(np.int32)
    for i, v in enumerate(EDGE_ROWS):
        rows[2 * i, i % k] = v
    if case.startswith("int8"):
        q, scale = quantize_int8(table)
        sdt = "bfloat16" if case == "int8_bf16" else "float32"
        return (q, jnp.asarray(scale).astype(getattr(jnp, sdt)),
                torch.from_numpy(q),
                torch.from_numpy(scale).to(getattr(torch, sdt)), rows)
    dt = "bfloat16" if case == "bf16" else "float32"
    t = torch.from_numpy(table).to(getattr(torch, dt))
    return (jnp.asarray(table).astype(getattr(jnp, dt)), None, t, None, rows)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_take_rows_matches_jnp_take(dtype):
    rng = np.random.default_rng(12)
    table = rng.normal(size=(N_TABLE, 6)).astype(np.float32) * 50
    if dtype == "int8":
        table = table.astype(np.int8)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    rows = np.array([[0, N_TABLE - 1, *EDGE_ROWS]], np.int32)
    for r in (rows, rows[0], rows.T.copy()):
        got = take_rows(t, torch.from_numpy(r))
        want = jnp.take(jt, jnp.asarray(r), axis=0)
        assert got.dtype == t.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    with pytest.raises(IndexError):  # as jnp.take from an empty axis
        jnp.take(jt[:0], jnp.asarray(rows), axis=0)
    with pytest.raises(IndexError):
        take_rows(t[:0], torch.from_numpy(rows))


@pytest.mark.parametrize("case", CASES)
def test_out_of_range_rows_match_jax(case):
    """gather_mean_reference (and the CPU route of gather_mean) against
    the JAX package's gather_mean and against jnp.take + dequantize_rows
    + mean, for wrapped and filled indices: NaN rows where the JAX rows
    are NaN, -128 * scale contributions for an int8 table."""
    jtable, jscale, t, s, rows = _edge_case(case)
    jrows = jnp.asarray(rows)
    if jscale is None:
        oracles = [jax_gather_mean(jtable, jrows),
                   jnp.take(jtable, jrows, axis=0).mean(axis=1)]
    else:
        oracles = [jax_gather_mean(jnp.asarray(jtable), jrows) * jscale,
                   dequantize_rows(jnp.take(jnp.asarray(jtable), jrows,
                                            axis=0), jscale).mean(axis=1)]
    for got in (gather_mean_reference(t, torch.from_numpy(rows), s),
                gather_mean(t, torch.from_numpy(rows), s)):
        got = _np(got)
        assert np.isnan(got).any() == (jscale is None)
        for want in oracles:
            want = _np(want)
            big = float(np.nanmax(np.abs(want)))
            if got.dtype == np.float32 and case in ("f32", "int8_f32"):
                atol = 1e-5 * big
            else:  # one bf16 rounding of the output vs the reference's
                atol = 2 ** -7 * big
            np.testing.assert_allclose(got, want, rtol=2 ** -7 if atol > 1e-5
                                       * big else 0, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_gather_feature_rows_out_of_range_matches_jax(case):
    """The port's gather_feature_rows (hops 0 and 1) against the
    reference's for wrapped and filled indices: identical take, and the
    same dequant."""
    jtable, jscale, t, s, rows = _edge_case(case)
    hops = [rows[:, 0].copy(), rows.reshape(-1)]
    jbatch = {"feature_table": jnp.asarray(jtable)}
    batch = {"feature_table": t}
    if jscale is not None:
        jbatch["feature_scale"], batch["feature_scale"] = jscale, s
    want = jax_gather_feature_rows(jbatch, [jnp.asarray(r) for r in hops])
    got = gather_feature_rows(batch, [torch.from_numpy(r) for r in hops])
    for g, w in zip(got, want):
        assert g.dtype == (s.dtype if s is not None else t.dtype)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))


def _plan(table, n=1003, k=10, scale=None, **kw):
    rows = torch.zeros((n, k), dtype=torch.int32)
    dt = scale.dtype if scale is not None else table.dtype
    out = torch.empty((n, table.shape[1]), dtype=dt)
    assert out.data_ptr() % 16 == 0
    return launch_plan(table, rows, out, scale, **kw)


@pytest.mark.parametrize("k", [1, 10, 33])
@pytest.mark.parametrize("case,d,vec,lanes", [
    # the main path's widths: D = 100 at V = 4 (int8), 8 (bf16), 16 (f32)
    ("int8_bf16", 100, 4, 25), ("int8_f32", 100, 4, 25),
    ("bf16", 100, 8, 25), ("f32", 100, 16, 25),
    # cora: 1433 int8 columns, one byte a lane over 45 column steps
    ("int8_f32", 1433, 1, 32), ("f32", 1433, 4, 32),
    ("int8_bf16", 1, 1, 1), ("f32", 1, 4, 1), ("bf16", 7, 2, 7),
    ("int8_f32", 7, 1, 7),
    # D = 128: the output's 16-byte vector caps int8 + f32 scale at V = 4
    ("int8_bf16", 128, 8, 16), ("int8_f32", 128, 4, 32),
    ("bf16", 128, 16, 16), ("f32", 128, 16, 32),
])
def test_launch_plan(case, d, vec, lanes, k):
    q = torch.zeros((50, d), dtype=torch.int8)
    if case.startswith("int8"):
        table = q
        scale = torch.ones(d, dtype=torch.bfloat16 if case == "int8_bf16"
                           else torch.float32)
    else:
        table, scale = q.to(torch.bfloat16 if case == "bf16"
                            else torch.float32), None
    assert table.data_ptr() % 16 == 0
    plan = _plan(table, k=k, scale=scale)
    assert (plan.vec_bytes, plan.lanes) == (vec, lanes)
    assert plan.elems * table.element_size() == vec
    assert plan.vectors_per_row * plan.elems == d
    assert plan.rows_per_block == 4 and plan.grid == 251  # ceil(1003 / 4)
    # one warp per row chunk of 32 vectors: cora's 1433 columns in 45
    assert plan.col_blocks == -(-plan.vectors_per_row // plan.lanes)


@pytest.mark.parametrize("case,d,vec", [
    ("int8_f32", 7, 1),      # t[1:] 7 bytes in
    ("int8_bf16", 100, 4),   # 100 bytes in: 4-aligned, as its rows
    ("f32", 7, 4),           # 28 bytes in
    ("bf16", 100, 8),        # 200 bytes in
])
def test_launch_plan_follows_the_real_pointer(case, d, vec):
    """A row view t[1:] starts one row into the buffer, and a view one
    element in is aligned to the element only: the vector narrows to
    what the address allows."""
    scale = None
    if case.startswith("int8"):
        t = torch.zeros((20, d), dtype=torch.int8)
        scale = torch.ones(d, dtype=torch.bfloat16 if case == "int8_bf16"
                           else torch.float32)
    else:
        t = torch.zeros((20, d), dtype=getattr(torch, {
            "f32": "float32", "bf16": "bfloat16"}[case]))
    assert _plan(t[1:], scale=scale).vec_bytes == vec
    shifted = torch.zeros(20 * d + 1, dtype=t.dtype)[1:].view(20, d)
    assert _plan(shifted, scale=scale).vec_bytes == t.element_size()
    # a misaligned scale or output narrows it too
    if scale is not None and d % 4 == 0:
        odd = torch.ones(d + 1, dtype=scale.dtype)[1:]
        assert _plan(t, scale=odd).vec_bytes == 1


def test_launch_plan_grid():
    """A warp per (row, chunk of 32 vectors): ceil(n / rows_per_block)
    blocks along the rows, col_blocks along the chunks."""
    t = torch.zeros((50, 100), dtype=torch.float32)
    assert _plan(t, n=1, k=1).grid == 1
    assert _plan(t, n=1003, rows_per_block=16).grid == 63
    wide = torch.zeros((50, 1433), dtype=torch.float32)  # 45 chunks of 32
    plan = _plan(wide, n=1003, rows_per_block=8)
    assert (plan.col_blocks, plan.grid) == (45, 126)
    with pytest.raises(ValueError):
        _plan(t, rows_per_block=17)
    with pytest.raises(ValueError):
        _plan(t, rows_per_block=0)
