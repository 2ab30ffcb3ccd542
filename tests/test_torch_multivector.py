"""Parity of the port's multivector, tie and fused multi-assignment with
vexcl_tpu.

The same numpy inputs (from a seed) go through both packages on the CPU,
where the port's k-output assignment kernel runs its plain version
(``triton_emit.assign_multi_plain``): multivector expressions, compound
ops, scalar and vector broadcast, component access, ``tie`` and the swap
idiom, ``make_temp`` and builtins over a multivector, ``copy``, SpMat and
SpMatCCSR times a multivector, vector-valued matrices, and ``enqueue``
onto ``tie`` and a multivector.

Tolerances, relative to the largest magnitude: f64 1e-12, f32 1e-6 (a
few ulp: the two packages round ``cos`` and ``exp`` differently); moves,
swaps and integer results exact.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.utils.poisson import poisson_7pt, poisson_7pt_ccsr

N = 1000
M = 3
RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _pair(data, ctx1, tctx, dtype=None):
    return (vex.multivector(data=data, dtype=dtype, context=ctx1),
            vt.multivector(data=data, dtype=dtype, context=tctx))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_multivector_expression(ctx1, tctx, dt):
    rng = np.random.default_rng(81)
    hx, hy = (rng.random((M, N)).astype(dt) for _ in range(2))
    (jx, tx), (jy, ty) = _pair(hx, ctx1, tctx), _pair(hy, ctx1, tctx)
    jz = vex.multivector(N, M, dtype=dt, context=ctx1)
    tz = vt.multivector(N, M, dtype=dt, context=tctx)
    jz[:] = 2 * jx - vex.cos(jy) / (jx + 1)
    tz[:] = 2 * tx - vt.cos(ty) / (tx + 1)
    assert tz.dtype == vt.dtype_of(dt) and tz.nparts == M and len(tz) == N
    _close(tz.to_numpy(), jz.to_numpy(), RTOL[dt])


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_multivector_compound_ops(ctx1, tctx, op):
    rng = np.random.default_rng(82)
    hx, hy = rng.random((M, N)) + 0.5, rng.random((M, N)) + 0.5
    (jx, tx), (jy, ty) = _pair(hx, ctx1, tctx), _pair(hy, ctx1, tctx)
    jx.assign(jy * 0.5 + jx, op)
    tx.assign(ty * 0.5 + tx, op)
    _close(tx.to_numpy(), jx.to_numpy(), 1e-12)
    # the operator forms
    tx2 = vt.multivector(data=hx, context=tctx)
    if op == "+=":
        tx2 += ty * 0.5 + tx2
    elif op == "-=":
        tx2 -= ty * 0.5 + tx2
    elif op == "*=":
        tx2 *= ty * 0.5 + tx2
    else:
        tx2 /= ty * 0.5 + tx2
    np.testing.assert_array_equal(tx2.to_numpy(), tx.to_numpy())


def test_scalar_and_vector_broadcast(ctx1, tctx):
    rng = np.random.default_rng(83)
    hx, hv = rng.random((M, N)), rng.random(N)
    jx, tx = _pair(hx, ctx1, tctx)
    jv = vex.vector(data=hv, context=ctx1)
    tv = vt.vector(data=hv, context=tctx)
    jx[:] = jx * jv + 3 - jv       # one vector broadcast over components
    tx[:] = tx * tv + 3 - tv
    _close(tx.to_numpy(), jx.to_numpy(), 1e-12)
    tx[:] = 7.0
    assert np.all(tx.to_numpy() == 7.0)
    tx[:] = (tv, 2 * tv, -tv)      # a tuple, one expression a component
    np.testing.assert_array_equal(tx.to_numpy(), np.stack([hv, 2 * hv, -hv]))
    with pytest.raises(ValueError):
        tx[:] = (tv, tv)


def test_component_access(ctx1, tctx):
    rng = np.random.default_rng(84)
    hx = rng.random((M, N))
    jx, tx = _pair(hx, ctx1, tctx)
    np.testing.assert_array_equal(tx(1).to_numpy(), np.asarray(jx(1)))
    assert tx[5] == jx[5] and len(tx[5]) == M
    tx[7] = (1.0, 2.0, 3.0)
    jx[7] = (1.0, 2.0, 3.0)
    np.testing.assert_array_equal(tx.to_numpy(), jx.to_numpy())
    assert [c.size for c in tx.components] == [N] * M
    # a 1-D array cut into m rows, as the reference constructor
    flat = vt.multivector(data=hx.ravel(), m=M, context=tctx)
    np.testing.assert_array_equal(flat.to_numpy(), hx)
    assert repr(tx) == f"multivector<{tx.dtype},{M}>[{N}]"


@pytest.mark.parametrize("dts", [(np.float64, np.float64),
                                 (np.float32, np.int32),
                                 (np.int32, np.float64)])
def test_tie(ctx1, tctx, dts):
    rng = np.random.default_rng(85)
    ha, hb = rng.random(N) * 10, rng.random(N) * 10
    ja, jb = (vex.vector(data=h, context=ctx1) for h in (ha, hb))
    ta, tb = (vt.vector(data=h, context=tctx) for h in (ha, hb))
    jx, jy = (vex.vector(N, dtype=d, context=ctx1) for d in dts)
    tx, ty = (vt.vector(N, dtype=d, context=tctx) for d in dts)
    vex.tie(jx, jy)[:] = (ja + jb, ja * jb - 1)
    vt.tie(tx, ty)[:] = (ta + tb, ta * tb - 1)
    assert tx.dtype == vt.dtype_of(dts[0]) and ty.dtype == vt.dtype_of(dts[1])
    _close(tx.to_numpy(), np.asarray(jx), 1e-12)
    _close(ty.to_numpy(), np.asarray(jy), 1e-12)


def test_tie_swap_and_targets_that_are_leaves(ctx1, tctx):
    """tie(x, y) = (y, x) swaps: every value is read before any store."""
    rng = np.random.default_rng(86)
    ha, hb = rng.random(N), rng.random(N)
    jx, jy = (vex.vector(data=h, context=ctx1) for h in (ha, hb))
    tx, ty = (vt.vector(data=h, context=tctx) for h in (ha, hb))
    vt.tie(tx, ty)[:] = (ty, tx)
    np.testing.assert_array_equal(tx.to_numpy(), hb)
    np.testing.assert_array_equal(ty.to_numpy(), ha)
    vex.tie(jx, jy)[:] = (jx + jy, jx - jy)
    vt.tie(tx, ty)[:] = (ty + tx, ty - tx)      # the old x, y again
    _close(tx.to_numpy(), np.asarray(jx), 1e-12)
    _close(ty.to_numpy(), np.asarray(jy), 1e-12)
    with pytest.raises(ValueError):
        vt.tie(tx, vt.vector(N + 1, dtype=np.float64, context=tctx))[:] = (
            tx, tx)


def test_make_temp_over_multivector(ctx1, tctx):
    rng = np.random.default_rng(87)
    hx = rng.random((M, N))
    jx, tx = _pair(hx, ctx1, tctx)
    jy = vex.multivector(N, M, dtype=np.float64, context=ctx1)
    ty = vt.multivector(N, M, dtype=np.float64, context=tctx)
    jt, tt = vex.make_temp(1, jx * 2), vt.make_temp(1, tx * 2)
    jy[:] = jt + jt
    ty[:] = tt + tt
    np.testing.assert_array_equal(ty.to_numpy(), jy.to_numpy())
    jt2, tt2 = vex.make_temp(2, vex.sin(jx)), vt.make_temp(2, vt.sin(tx))
    jy[:] = jt2 * jt2 + 1
    ty[:] = tt2 * tt2 + 1
    _close(ty.to_numpy(), jy.to_numpy(), 1e-12)


def test_copy(ctx1, tctx):
    rng = np.random.default_rng(88)
    hx = rng.random((M, N))
    jx, tx = _pair(hx, ctx1, tctx)
    jc, tc = jx.copy(), tx.copy()
    jc += 1.0
    tc += 1.0
    np.testing.assert_array_equal(tx.to_numpy(), hx)
    np.testing.assert_array_equal(tc.to_numpy(), jc.to_numpy())


@pytest.mark.parametrize("name,args", [
    ("sin", ("x",)), ("exp", ("x",)), ("fabs", ("x",)),
    ("pow", ("x", 2.5)), ("fmax", ("x", "y")), ("atan2", ("y", "x"))])
def test_builtins_lifted_over_multivector(ctx1, tctx, name, args):
    rng = np.random.default_rng(89)
    hx, hy = rng.random((M, N)) - 0.3, rng.random((M, N))
    (jx, tx), (jy, ty) = _pair(hx, ctx1, tctx), _pair(hy, ctx1, tctx)
    jm, tm = {"x": jx, "y": jy}, {"x": tx, "y": ty}
    jz = vex.multivector(N, M, dtype=np.float64, context=ctx1)
    tz = vt.multivector(N, M, dtype=np.float64, context=tctx)
    jz[:] = getattr(vex, name)(*[jm.get(a, a) for a in args])
    tz[:] = getattr(vt, name)(*[tm.get(a, a) for a in args])
    _close(tz.to_numpy(), jz.to_numpy(), 1e-12)


@pytest.mark.parametrize("fmt", [None, "csr"])
def test_spmat_times_multivector(ctx1, tctx, fmt):
    """A scalar matrix applied to each component, inside a fused
    assignment (one product per component, then one kernel)."""
    rng = np.random.default_rng(90)
    ptr, col, val = poisson_7pt(8)
    n = 8 ** 3
    hx = rng.random((M, n))
    jA = vex.SpMat(n, n, ptr, col, val, fmt=fmt, context=ctx1)
    tA = vt.SpMat(n, n, ptr, col, val, fmt=fmt, context=tctx)
    jx, tx = _pair(hx, ctx1, tctx)
    jy = vex.multivector(n, M, dtype=np.float64, context=ctx1)
    ty = vt.multivector(n, M, dtype=np.float64, context=tctx)
    jy[:] = 2 * (jA * jx) - jx
    ty[:] = 2 * (tA * tx) - tx
    _close(ty.to_numpy(), jy.to_numpy(), 1e-12)
    tx[:] = tA * tx                 # in place: the products read the old x
    _close(tx.to_numpy(), (jy.to_numpy() + hx) / 2, 1e-12)


def test_vector_valued_spmat_and_ccsr(ctx1, tctx):
    """val of shape (nnz, k): plane c applies to component c."""
    rng = np.random.default_rng(91)
    ptr, col, val = poisson_7pt(8)
    n = 8 ** 3
    vals = np.stack([val, 2 * val + 1], axis=1)
    hx = rng.random((2, n))
    jx, tx = _pair(hx, ctx1, tctx)
    for fmt in (None, "csr"):
        jA = vex.SpMat(n, n, ptr, col, vals, fmt=fmt, context=ctx1)
        tA = vt.SpMat(n, n, ptr, col, vals, fmt=fmt, context=tctx)
        jy = vex.multivector(n, 2, dtype=np.float64, context=ctx1)
        ty = vt.multivector(n, 2, dtype=np.float64, context=tctx)
        jy[:] = jA * jx
        ty[:] = tA * tx
        _close(ty.to_numpy(), jy.to_numpy(), 1e-12)
    idx, row, ccol, cval = poisson_7pt_ccsr(8)
    cvals = np.stack([cval, 3 * cval], axis=1)
    jC = vex.SpMatCCSR(n, n, idx, row, ccol, cvals, context=ctx1)
    tC = vt.SpMatCCSR(n, n, idx, row, ccol, cvals, context=tctx)
    jy[:] = jC * jx + jx
    ty[:] = tC * tx + tx
    _close(ty.to_numpy(), jy.to_numpy(), 1e-12)
    assert tC.n == n and tC.dtype == torch.float64


def test_enqueue_onto_tie_and_multivector(ctx1, tctx):
    rng = np.random.default_rng(92)
    n = 256
    ha, hm = rng.random(n), rng.random((M, n))
    ja = vex.vector(data=ha, context=ctx1)
    ta = vt.vector(data=ha, context=tctx)
    jx, jy = (vex.vector(n, dtype=np.float64, context=ctx1) for _ in "xy")
    tx, ty = (vt.vector(n, dtype=np.float64, context=tctx) for _ in "xy")
    other = vt.Context(device="cpu", set_current=False)
    vex.enqueue(ctx1)(vex.tie(jx, jy))[:] = (ja * 2, ja * 3)
    storage = tx.storage
    vt.enqueue(other)(vt.tie(tx, ty))[:] = (ta * 2, ta * 3)
    assert tx.storage is storage            # same device: in place
    p = vt.enqueue(other)(vt.tie(tx, ty))
    p += (ta, ta)
    jp = vex.enqueue(ctx1)(vex.tie(jx, jy))
    jp += (ja, ja)
    np.testing.assert_array_equal(tx.to_numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.to_numpy(), np.asarray(jy))
    jm, tm = _pair(hm, ctx1, tctx)
    jm2 = vex.multivector(n, M, dtype=np.float64, context=ctx1)
    tm2 = vt.multivector(n, M, dtype=np.float64, context=tctx)
    vex.enqueue(ctx1)(jm2)[:] = jm * 2 + 1
    vt.enqueue(other)(tm2)[:] = tm * 2 + 1
    np.testing.assert_array_equal(tm2.to_numpy(), jm2.to_numpy())
