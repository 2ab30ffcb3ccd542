"""Parity of the port's DIA format and SpMV with vexcl_tpu.

The port's plain DIA SpMV (the CPU form of sparse/cuda_dia.py) is held
against ``vexcl_tpu.sparse.pallas_dia.dia_matvec_pallas_roll`` in
interpret mode, as tests/test_spmv.py runs it; the bf16 plane decision,
``DIA.from_arrays`` on the JAX package's state and ``SpMat`` on Poisson
16³ are compared through both APIs.

Tolerances: f32 3e-5 (as tests/test_spmv.py), f64 1e-12 relative to the
largest magnitude; integer-valued data exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.sparse.pallas_dia import dia_matvec_pallas_roll
from vexcl_tpu.utils.poisson import poisson_7pt
from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec_plain
from vexcl_tpu_torch.sparse.dia import DIA


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("offs", [(-1, 0, 1), (-4096, -64, -1, 0, 1, 64, 4096)])
def test_plain_dia_matches_pallas_roll_interpret(offs):
    rng = np.random.default_rng(31)
    n = 1 << 18
    d = len(offs)
    vals = rng.random((d, n)).astype(np.float32)
    i = np.arange(n)
    for k, o in enumerate(offs):
        vals[k, (i + o < 0) | (i + o >= n)] = 0
    x = rng.random(n).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda v, xx: dia_matvec_pallas_roll(n, n, offs, v, xx))(
            jnp.asarray(vals), jnp.asarray(x)))
    got = dia_matvec_plain(n, n, offs, torch.from_numpy(vals),
                           torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want, 3e-5)


@pytest.mark.parametrize("dt,planes", [(np.float32, "bfloat16"),
                                       (np.float64, "float64")])
def test_bf16_plane_decision_matches(ctx1, tctx, dt, planes):
    ptr, col, val = poisson_7pt(6, dtype=dt)
    jA = vex.SpMat(216, 216, ptr, col, val, context=ctx1)
    tA = vt.SpMat(216, 216, ptr, col, val, context=tctx)
    assert str(jA.device.vals.dtype) == planes
    assert str(tA.device.vals.dtype) == "torch." + planes
    assert tA.device.offsets == jA.device.offsets
    # the logical value type stays the matrix's own
    assert tA.dtype == vt.dtype_of(dt)
    # values bf16 cannot hold keep f32 planes in both packages
    rng = np.random.default_rng(32)
    val2 = rng.random(len(val)).astype(np.float32)
    jB = vex.SpMat(216, 216, ptr, col, val2, context=ctx1)
    tB = vt.SpMat(216, 216, ptr, col, val2, context=tctx)
    assert str(jB.device.vals.dtype) == "float32"
    assert tB.device.vals.dtype == torch.float32


def test_dia_from_jax_state(ctx1, tctx):
    """The converter: a JAX package DIA's arrays become the port's DIA,
    bf16 planes included, and both give the same SpMV."""
    ptr, col, val = poisson_7pt(10, dtype=np.float32)
    jA = vex.SpMat(1000, 1000, ptr, col, val, context=ctx1)
    jd = jA.device
    td = DIA.from_arrays(jd.n, jd.m, jd.offsets, np.asarray(jd.vals),
                         device=tctx.device)
    assert td.vals.dtype == torch.bfloat16
    x = np.random.default_rng(33).random(1000).astype(np.float32)
    want = np.asarray(jd.apply(jnp.asarray(x)))
    _close(td.apply(torch.from_numpy(x)), want, 1e-6)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_spmat_poisson16_parity(ctx1, tctx, dt):
    n = 16
    ptr, col, val = poisson_7pt(n, dtype=dt)
    N = n ** 3
    jA = vex.SpMat(N, N, ptr, col, val, context=ctx1)
    tA = vt.SpMat(N, N, ptr, col, val, context=tctx)
    rng = np.random.default_rng(34)
    hx, hy = rng.random(N).astype(dt), rng.random(N).astype(dt)
    jx, jy = (vex.vector(data=a, context=ctx1) for a in (hx, hy))
    tx, ty = (vt.vector(data=a, context=tctx) for a in (hx, hy))
    rtol = 1e-12 if dt == np.float64 else 1e-6
    jy[:] = jA * jx
    ty[:] = tA * tx
    _close(np.asarray(ty), np.asarray(jy), rtol)
    jy[:] = 0.5 * (jA * jx) + jy
    ty[:] = 0.5 * (tA * tx) + ty
    _close(np.asarray(ty), np.asarray(jy), rtol)
    s_j = vex.Reductor(vex.SUM)(jx * (jA * jx))
    s_t = vt.Reductor(vt.SUM)(tx * (tA * tx))
    assert abs(s_t - s_j) <= (1e-12 if dt == np.float64 else 1e-5) * abs(s_j)
    # in place: the SpMV reads x before the assignment overwrites it
    jx[:] = jA * jx
    tx[:] = tA * tx
    _close(np.asarray(tx), np.asarray(jx), rtol)


def test_rectangular_and_empty_dia(ctx1, tctx):
    rng = np.random.default_rng(35)
    n, m = 500, 700
    offs = np.array([-3, 0, 2, 150])
    rows, cols, vals = [], [], []
    for o in offs:
        i = np.arange(n)
        ok = (i + o >= 0) & (i + o < m)
        rows += list(i[ok])
        cols += list(i[ok] + o)
        vals += list(rng.integers(-4, 5, ok.sum()).astype(np.float64))
    order = np.lexsort((cols, rows))
    rows, cols, vals = (np.asarray(a)[order] for a in (rows, cols, vals))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    tA = vt.SpMat(n, m, ptr, cols, vals, context=tctx)
    jA = vex.SpMat(n, m, ptr, cols, vals, context=ctx1)
    assert tA.device.format == "dia"
    hx = rng.random(m)
    tx = vt.vector(data=hx, context=tctx)
    jx = vex.vector(data=hx, context=ctx1)
    ty = vt.vector(n, dtype=np.float64, context=tctx)
    ty[:] = tA * tx
    _close(np.asarray(ty), np.asarray(vex.eval(jA * jx)), 1e-12)
    empty = DIA(n, m, [], np.zeros((0, n)), device=tctx.device)
    assert torch.equal(empty.apply(torch.from_numpy(hx)),
                       torch.zeros(n, dtype=torch.float64))


def test_vector_valued_matrices_raise(tctx):
    """val of shape (nnz, k) acts on a k-component multivector only
    (tests/test_torch_multivector.py holds its products)."""
    ptr, col, val = poisson_7pt(4)
    vals = np.stack([val, 2 * val], axis=1)
    x = vt.vector(data=np.ones(64), context=tctx)
    x3 = vt.multivector(data=np.ones((3, 64)), context=tctx)
    for fmt in (None, "csr", "ell", "hyb", "sellr", "dia"):
        A = vt.SpMat(64, 64, ptr, col, vals, fmt=fmt, context=tctx)
        with pytest.raises(TypeError, match="multivector"):
            A * x
        with pytest.raises(ValueError, match="multivector"):
            A * x3
    C = vt.SpMatCCSR(64, 64, np.zeros(64, np.int32), [0, 1], [0],
                     np.ones((1, 2)), context=tctx)
    with pytest.raises(TypeError, match="multivector"):
        C * x


@pytest.mark.parametrize("planes, xs", [
    (torch.complex64, torch.complex64), (torch.complex128, torch.complex128),
    (torch.float32, torch.complex64), (torch.complex64, torch.float32)])
def test_complex_dia_by_real_parts(planes, xs):
    """On the card a complex DIA product runs the real kernel over the
    parts (``DIA.by_real_parts``); here that arithmetic, through the
    kernel's plain version, against the complex plain product."""
    rng = np.random.default_rng(17)
    n, offs = 40, (-2, 0, 3)
    v = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    vals = torch.from_numpy(v if planes.is_complex else v.real).to(planes)
    xt = torch.from_numpy(x if xs.is_complex else x.real).to(xs)
    A = DIA(n, n, offs, vals, device=torch.device("cpu"), compress=False)
    got = A.by_real_parts(xt)
    want = A.apply(xt)
    assert got.dtype == want.dtype
    tol = 1e-5 if torch.complex64 in (planes, xs) or \
        torch.float32 in (planes, xs) else 1e-12
    assert torch.allclose(got, want, rtol=0, atol=tol * want.abs().max())
