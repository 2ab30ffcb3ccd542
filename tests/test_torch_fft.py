"""FFT: the PyTorch port against vexcl_tpu on the CPU.

The cases of ``tests/test_fft.py``: powers of two, mixed radix, primes
(Bluestein in the ``"ct"`` engine), real input, 2-D, batched, an FFT in
an expression, the plan cache and the ct engine against the default
one.  The same numpy-seeded inputs go through ``vexcl_tpu`` (JAX on the
CPU, x64: c128) and ``vexcl_tpu_torch`` in c128 (``dtype=``: the port's
default is c64).  Tolerances: rtol 1e-7 and atol 1e-8 against
``np.fft`` for either package (``test_fft.py``'s); the two packages
against each other 1e-9 of the largest magnitude (two FFT libraries, or
the same ct plan in another summation order).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt

C128 = np.complex128


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _both(ctx1, tctx, hx, shape, **kw):
    """(JAX, port) results of the transform of ``hx`` over ``shape``."""
    n = hx.size
    x = vex.vector(data=hx.ravel(), context=ctx1)
    y = vex.vector(n, dtype=C128, context=ctx1)
    y[:] = vex.FFT(shape, **kw)(x)
    tx = vt.vector(data=hx.ravel(), context=tctx)
    ty = vt.vector(n, dtype=C128, context=tctx)
    ty[:] = vt.FFT(shape, dtype=C128, **kw)(tx)
    return np.asarray(y), ty.to_numpy()


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-9 * max(np.abs(b).max(), 1.0))


def _roundtrip(ctx1, tctx, n, impl):
    rng = np.random.default_rng(n)
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    jy, ty = _both(ctx1, tctx, hx, n, impl=impl)
    np.testing.assert_allclose(ty, np.fft.fft(hx), rtol=1e-7, atol=1e-8)
    _close(ty, jy)
    tz = vt.vector(n, dtype=C128, context=tctx)
    tz[:] = vt.FFT(n, inverse=True, dtype=C128, impl=impl)(
        vt.vector(data=ty, context=tctx))
    np.testing.assert_allclose(tz.to_numpy(), hx, rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("impl", ["xla", "ct"])
@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_pow2(ctx1, tctx, n, impl):
    _roundtrip(ctx1, tctx, n, impl)


@pytest.mark.parametrize("impl", ["xla", "ct"])
@pytest.mark.parametrize("n", [3 * 5 * 7, 729, 1000, 1536])
def test_mixed_radix(ctx1, tctx, n, impl):
    _roundtrip(ctx1, tctx, n, impl)


@pytest.mark.parametrize("impl", ["xla", "ct"])
@pytest.mark.parametrize("n", [17, 97, 1009])
def test_prime_bluestein(ctx1, tctx, n, impl):
    _roundtrip(ctx1, tctx, n, impl)


def test_real_input(ctx1, tctx, rng):
    """A real input is cast to complex before the transform (no rfft):
    the output has the input's length."""
    n = 512
    hx = rng.standard_normal(n)
    jy, ty = _both(ctx1, tctx, hx, n)
    np.testing.assert_allclose(ty, np.fft.fft(hx), rtol=1e-7, atol=1e-8)
    _close(ty, jy)


def test_2d(ctx1, tctx, rng):
    rows, cols = 32, 48
    hx = rng.standard_normal((rows, cols)) + 1j * rng.standard_normal(
        (rows, cols))
    for impl in ("xla", "ct"):
        jy, ty = _both(ctx1, tctx, hx, (rows, cols), impl=impl)
        np.testing.assert_allclose(ty.reshape(rows, cols), np.fft.fft2(hx),
                                   rtol=1e-7, atol=1e-8)
        _close(ty, jy)


def test_batched(ctx1, tctx, rng):
    """fft::none batch dims (fft.hpp dims)."""
    batch, n = 16, 128
    hx = rng.standard_normal((batch, n)) + 1j * rng.standard_normal(
        (batch, n))
    for impl in ("xla", "ct"):
        jy, ty = _both(ctx1, tctx, hx, (batch, n), dims=(1,), impl=impl)
        np.testing.assert_allclose(ty.reshape(batch, n),
                                   np.fft.fft(hx, axis=1), rtol=1e-7,
                                   atol=1e-8)
        _close(ty, jy)


def test_fft_in_expression(ctx1, tctx, rng):
    """An FFT in an expression: y = fft(x) * conj(fft(x)), the transform
    hoisted into a temporary and the rest one (complex) assignment."""
    n = 256
    hx = rng.standard_normal(n)
    x = vex.vector(data=hx, context=ctx1)
    p = vex.vector(n, dtype=C128, context=ctx1)
    fx = vex.make_temp(1, vex.FFT(n)(x))
    p[:] = fx * vex.conj(fx)
    tx = vt.vector(data=hx, context=tctx)
    tp = vt.vector(n, dtype=C128, context=tctx)
    tfx = vt.make_temp(1, vt.FFT(n, dtype=C128)(tx))
    tp[:] = tfx * vt.conj(tfx)
    np.testing.assert_allclose(tp.to_numpy(), np.abs(np.fft.fft(hx)) ** 2,
                               rtol=1e-6, atol=1e-8)
    _close(tp.to_numpy(), np.asarray(p))
    # with more nodes around it, and as its own input's expression
    tp[:] = 2.0 * vt.FFT(n, dtype=C128)(tx * 0.5) + 1j
    np.testing.assert_allclose(tp.to_numpy(), np.fft.fft(hx) + 1j,
                               rtol=1e-7, atol=1e-8)


def test_direct_into_target_and_aliasing(tctx, rng):
    """A tree that is only the transform writes straight into its target;
    one that reads its target goes through a temporary."""
    n = 128
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = vt.vector(data=hx, context=tctx)
    f = vt.FFT(n, dtype=C128)
    y = vt.vector(n, dtype=C128, context=tctx)
    ptr = y.storage.data_ptr()
    y[:] = f(x)
    assert y.storage.data_ptr() == ptr
    np.testing.assert_allclose(y.to_numpy(), np.fft.fft(hx), rtol=1e-7,
                               atol=1e-8)
    x[:] = f(x)         # in place: the input is read before the write
    np.testing.assert_allclose(x.to_numpy(), np.fft.fft(hx), rtol=1e-7,
                               atol=1e-8)


def test_plan_cache():
    from vexcl_tpu_torch.ops.fft import plan_cache

    vt.FFT(2048)
    a = len(plan_cache)
    vt.FFT(2048)
    assert len(plan_cache) == a
    vt.FFT(2048, impl="ct")
    assert len(plan_cache) == a + 1


@pytest.mark.parametrize("n", [4096, 729, 1009])
def test_ct_engine_matches_xla_engine(ctx1, tctx, rng, n):
    """Both engines agree (impl='ct' is the ported planner), and each
    agrees with the JAX package's ct engine."""
    hx = rng.standard_normal(n)
    jy, ty = _both(ctx1, tctx, hx, n, impl="ct")
    _, tx_ = _both(ctx1, tctx, hx, n, impl="xla")
    np.testing.assert_allclose(ty, tx_, rtol=1e-7, atol=1e-8)
    _close(ty, jy)


def test_ct_engine_c64_planner():
    """The ct engine in c64 (the card's type) against numpy's f64 FFT: the
    octant-reduced twiddles keep its relative L2 error near f32 rounding;
    its stage plan is the JAX package's."""
    from vexcl_tpu.ops.fft import _radix_plan as jplan

    from vexcl_tpu_torch.ops.fft import MAX_CODELET, Plan, _radix_plan

    for n in (1 << 12, 3 * 5 * 7 * 64, 1 << 16):
        assert _radix_plan(n, MAX_CODELET) == jplan(n, 256)
        rng = np.random.default_rng(n)
        hx = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        got = Plan((n,), None, False, torch.complex64, impl="ct")(
            torch.from_numpy(hx.astype(np.complex64))).numpy()
        ref = np.fft.fft(hx.astype(np.complex64).astype(C128))
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-6


def test_sig_separates_engines_and_dist_raises(tctx):
    """xla, ct and dist plans of one geometry have distinct signatures;
    impl='dist' (the four-step transform over parts) raises over a vector
    of one part."""
    from vexcl_tpu_torch.ops.fft import FFTExpr, Plan

    x = vt.vector(64, dtype=np.complex64, context=tctx)
    sx = FFTExpr(Plan((64,), None, False, torch.complex64), x).extra_sig()
    sc = FFTExpr(Plan((64,), None, False, torch.complex64, "ct"),
                 x).extra_sig()
    sd = FFTExpr(Plan((64,), None, False, torch.complex64, "dist"),
                 x).extra_sig()
    assert len({sx, sc, sd}) == 3
    with pytest.raises(ValueError, match="several parts"):
        vt.vector(64, dtype=np.complex64, context=tctx).assign(
            vt.FFT(64, impl="dist")(x))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape, dims", [((512,), None), ((16, 24), None),
                                         ((8, 64), (1,)), ((64, 8), (0,))])
def test_vector_direct_path_matches_jax(ctx1, tctx, rng, shape, dims,
                                        inverse):
    """``y[:] = FFT(shape)(x)`` of a vector into a whole vector goes from
    ``vector.assign`` to the plan (``FFTExpr.into_vector``), forward and
    inverse, 1-D, 2-D and batched over the leading or the trailing axis,
    and gives the JAX package's transform."""
    from vexcl_tpu_torch.ops.fft import FFTExpr

    n = int(np.prod(shape))
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = vex.vector(data=hx, context=ctx1)
    y = vex.vector(n, dtype=C128, context=ctx1)
    y[:] = vex.FFT(shape, dims=dims, inverse=inverse)(x)
    tx = vt.vector(data=hx, context=tctx)
    ty = vt.vector(n, dtype=C128, context=tctx)
    f = vt.FFT(shape, dims=dims, inverse=inverse, dtype=C128)
    taken = []
    into = FFTExpr.into_vector
    try:
        FFTExpr.into_vector = lambda self, v: taken.append(into(self, v)) \
            or taken[-1]
        ty[:] = f(tx)
    finally:
        FFTExpr.into_vector = into
    assert taken == [True]
    _close(ty.to_numpy(), np.asarray(y))


def test_direct_path_declines_other_targets(ctx1, tctx, rng):
    """A target of another type, a slice of a vector, and an input that is
    the target take the general path, with the JAX package's results."""
    n = 256
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = np.fft.fft(hx)
    tx = vt.vector(data=hx, context=tctx)
    f = vt.FFT(n, dtype=C128)
    y64 = vt.vector(n, dtype=np.complex64, context=tctx)
    assert not f(tx).into_vector(y64)
    y64[:] = f(tx)
    np.testing.assert_allclose(y64.to_numpy(), want, rtol=1e-5, atol=1e-4)
    # a slice target: the transform into a temporary, stored through V3
    big = vt.vector(2 * n, dtype=C128, context=tctx)
    big[n:] = f(tx)
    jbig = vex.vector(2 * n, dtype=C128, context=ctx1)
    jbig[n:] = vex.FFT(n)(vex.vector(data=hx, context=ctx1))
    _close(big.to_numpy(), np.asarray(jbig))
    assert not f(tx).into_vector(tx)


def test_interop_holder_sees_the_transform(tctx, rng):
    """A tensor that shares the target's memory (``interop.to_dlpack``)
    sees the transform: it is written into the target's own storage."""
    n = 1024
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    tx = vt.vector(data=hx, context=tctx)
    ty = vt.vector(n, dtype=C128, context=tctx)
    holder = torch.utils.dlpack.from_dlpack(vt.interop.to_dlpack(ty))
    ty[:] = vt.FFT(n, dtype=C128)(tx)
    np.testing.assert_allclose(holder.numpy(), np.fft.fft(hx), rtol=1e-7,
                               atol=1e-8)
    ty[:] = vt.FFT(n, dtype=C128, inverse=True)(tx)
    np.testing.assert_allclose(holder.numpy(), np.fft.ifft(hx), rtol=1e-7,
                               atol=1e-8)


def test_plan_into_an_out_of_another_type(rng):
    """A c64 plan called with a c128 ``out`` (and a c64 one) writes the
    transform into it, cast, as ``torch.fft.fftn(out=)`` does: an ``out``
    that is not of the plan's type never reaches cuFFT."""
    from vexcl_tpu_torch.ops.fft import Plan

    n = 512
    hx = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = torch.from_numpy(hx).to(torch.complex64)
    want = np.fft.fft(x.numpy().astype(C128))
    for dt in (torch.complex128, torch.complex64):
        out = torch.zeros(n, dtype=dt)
        assert Plan((n,), None, False, np.complex64)(x, out) is out
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_cufft_layout_covers_leading_or_trailing_axes():
    """One cuFFT plan covers 1-3 transformed axes that lead or trail the
    shape; the rest keep torch.fft."""
    from vexcl_tpu_torch.ops.cufft import layout

    assert layout((1 << 20,), (0,)) == ((1 << 20,), 1, 1, 1 << 20)
    assert layout((64, 256), (1,)) == ((256,), 64, 1, 256)
    assert layout((64, 256), (0,)) == ((64,), 256, 256, 1)
    assert layout((8, 16, 32), (0, 1)) == ((8, 16), 32, 32, 1)
    assert layout((8, 16, 32), (1,)) is None
    assert layout((2, 3, 4, 5), (0, 1, 2, 3)) is None
    assert layout((8, 16, 32), (0, 2)) is None
