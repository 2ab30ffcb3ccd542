"""Parity of the port's stencils with vexcl_tpu.

The port's plain stencil (the CPU form of ops/cuda_stencil.py) is held
against ``vexcl_tpu.ops.pallas_stencil.stencil_pallas`` in interpret mode
at the cases of tests/test_stencil.py (f32, taps across lane rows, the
donated in-place form), and ``stencil``/``StencilOperator`` against the
JAX package's public API: values, the inferred result type, edge
replication with n < width, bad centers and operator identity.

Tolerances: f32 3e-5 (as tests/test_stencil.py's 2e-5 plus another order
of rounding), f64 1e-12, relative to the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.expr.node import analyze as jax_analyze
from vexcl_tpu.ops.pallas_stencil import stencil_pallas
from vexcl_tpu_torch.expr.node import analyze
from vexcl_tpu_torch.ops.cuda_stencil import stencil_plain

N = 4096


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max(initial=0))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("n,w,c", [(1 << 16, 5, 2), (1 << 16, 3, 0),
                                   (1 << 16, 129, 64)])
def test_plain_stencil_matches_pallas_interpret(n, w, c):
    rng = np.random.default_rng(51 + w)
    hx = rng.random(n).astype(np.float32)
    s = (rng.random(w).astype(np.float32) - 0.5) / w
    want = np.asarray(jax.jit(lambda v: stencil_pallas(v, s, c))(
        jnp.asarray(hx)))
    got = stencil_plain(torch.from_numpy(hx), torch.from_numpy(s), c)
    assert got.dtype == torch.float32
    _close(got, want, 3e-5)


def test_in_place_matches_donated_pallas(tctx):
    """x[:] = x * s reads the old x, as the donated Pallas kernel does."""
    rng = np.random.default_rng(52)
    hx = rng.random(1 << 17).astype(np.float32)
    s = (rng.random(7).astype(np.float32) - 0.5) / 7
    want = np.asarray(jax.jit(lambda v: stencil_pallas(v, s, 3, donate=True))(
        jnp.asarray(hx)))
    x = vt.vector(data=hx, context=tctx)
    x[:] = x * vt.stencil(s, 3)
    assert x.dtype == torch.float32
    _close(x, want, 3e-5)


_CASES = {
    "sym5": ([0.1, 0.2, 0.4, 0.2, 0.1], 2),
    "asym": ([1.0, -2.0, 1.0, 0.5], 0),
    "last": ([0.25, 0.5, 0.25, 1.0], 3),
    "wide": (list(np.linspace(-1, 1, 255)), 40),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("n", [N, 3, 1])
def test_stencil_matches_jax(ctx1, tctx, case, n):
    """f64 data; n < width replicates the one or few edge values."""
    taps, center = _CASES[case]
    hx = np.random.default_rng(53 + n).random(n)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    jy = vex.vector(n, dtype=np.float64, context=ctx1)
    ty = vt.vector(n, dtype=np.float64, context=tctx)
    jy[:] = jx * vex.stencil(taps, center=center)
    ty[:] = tx * vt.stencil(taps, center=center)
    _close(ty, jy, 1e-12)
    # inside an expression, and in place
    jy[:] = jx * vex.stencil(taps, center=center) + 2 * jx
    ty[:] = tx * vt.stencil(taps, center=center) + 2 * tx
    _close(ty, jy, 1e-12)
    jx[:] = jx * vex.stencil(taps, center=center)
    tx[:] = tx * vt.stencil(taps, center=center)
    _close(tx, jx, 1e-12)


@pytest.mark.parametrize("xdt,taps", [
    (np.float32, [0.25, 0.5, 0.25]),                     # Python floats: f64
    (np.float32, np.asarray([0.25, 0.5, 0.25], np.float32)),
    (np.float64, np.asarray([0.25, 0.5, 0.25], np.float32)),
    (np.int32, [0.25, 0.5, 0.25]),
    (np.int32, np.asarray([1, 2, 1], np.int32)),
])
def test_inferred_dtype_matches_jax(ctx1, tctx, xdt, taps):
    hx = (np.random.default_rng(54).random(N) * 10).astype(xdt)
    want = vex.eval(vex.vector(data=hx, context=ctx1)
                    * vex.stencil(taps, center=1))
    got = vt.eval(vt.vector(data=hx, context=tctx) * vt.stencil(taps, center=1))
    assert got.dtype == vt.dtype_of(np.asarray(want).dtype)
    _close(got, want, 3e-5 if got.dtype == torch.float32 else 1e-12)


def test_stencil_from_jax_state(ctx1, tctx):
    """The constructor takes a JAX stencil's coeff and center as they are:
    same taps, type and signature digest."""
    js = vex.stencil(np.asarray([0.1, 0.3, 0.6], np.float32), center=2)
    ts = vt.stencil(np.asarray(js.coeff), js.center)
    assert ts.digest == js.digest and ts.coeff.dtype == torch.float32
    hx = np.random.default_rng(55).random(N).astype(np.float32)
    want = vex.eval(vex.vector(data=hx, context=ctx1) * js)
    _close(vt.eval(vt.vector(data=hx, context=tctx) * ts), want, 3e-5)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_stencil_operator_matches_jax(ctx1, tctx, dt):
    hx = np.random.default_rng(56).random(N).astype(dt)

    @vex.stencil_operator(width=3, center=1)
    def jop(X):
        return X[0] + (X[-1] + X[1]) ** 3

    @vt.stencil_operator(width=3, center=1)
    def top(X):
        return X[0] + (X[-1] + X[1]) ** 3

    jy = vex.vector(N, dtype=dt, context=ctx1)
    ty = vt.vector(N, dtype=dt, context=tctx)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    jy[:] = jop(jx)
    ty[:] = top(tx)
    assert ty.dtype == vt.dtype_of(dt)
    _close(ty, jy, 3e-5 if dt == np.float32 else 1e-12)
    # an asymmetric window, fused with more expression, in place
    jop2 = vex.StencilOperator(4, 3, lambda X: X[-3] - 2 * X[0] * X[-1])
    top2 = vt.StencilOperator(4, 3, lambda X: X[-3] - 2 * X[0] * X[-1])
    jx[:] = jop2(jx) + jx
    tx[:] = top2(tx) + tx
    _close(tx, jx, 3e-5 if dt == np.float32 else 1e-12)


def test_bad_center_raises():
    for mod in (vex, vt):
        for c in (-1, 3):
            with pytest.raises(ValueError):
                mod.stencil([1.0, 2.0, 1.0], center=c)
    with pytest.raises(ValueError):
        vt.StencilOperator(3, 3, lambda X: X[0])
    tctx = vt.Context(vt.Filter.CPU, set_current=False)
    x = vt.vector(data=np.ones(8), context=tctx)
    with pytest.raises(IndexError):      # X[k] outside the window
        vt.eval(vt.StencilOperator(3, 1, lambda X: X[2])(x))


def test_equal_named_operators_keep_apart(ctx1, tctx):
    """Same (name, width, center), other bodies: other signatures, and
    each gives its own values, as in the JAX package."""
    hx = np.random.default_rng(57).random(N)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    jops = [vex.StencilOperator(3, 1, lambda X: X[0] + X[1], name="dup"),
            vex.StencilOperator(3, 1, lambda X: X[0] - X[-1], name="dup")]
    tops = [vt.StencilOperator(3, 1, lambda X: X[0] + X[1], name="dup"),
            vt.StencilOperator(3, 1, lambda X: X[0] - X[-1], name="dup")]
    assert analyze(tops[0](tx)).sig != analyze(tops[1](tx)).sig
    assert jax_analyze(jops[0](jx)).sig != jax_analyze(jops[1](jx)).sig
    for jop, top in zip(jops, tops):
        _close(vt.eval(top(tx)), vex.eval(jop(jx)), 1e-12)
