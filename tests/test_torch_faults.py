"""The port's plain forms against vexcl_tpu on the CPU where they once
differed (ROADMAP.md §3, the faults repaired in the port).

Each case gives the same seeded numpy inputs to ``vexcl_tpu`` (JAX on
the CPU, x64) and to ``vexcl_tpu_torch`` (``Context(Filter.CPU)``) and
takes the expected values and types from ``vexcl_tpu``:

* integer ``//``, ``%`` and ``fmod`` with zeros (and -1 under the least
  signed integer) in the divisor: XLA's values, exact;
* ``sign`` at NaN, ±0, ±inf and of complex values, and ``cbrt(-0.0)``:
  equal, signs of zeros included;
* complex ``round``, ``rint`` and ``nearbyint`` (each part rounded) and
  ``ceil``, ``floor``, ``trunc`` (TypeError in both);
* complex MIN and MAX through the Reductor and ``reduce_view`` of complex
  values (numpy's lexicographic order; sums and products within 1e-12 of
  the largest magnitude);
* the result types of ``pow``/``pown``/``powr`` of integers and of
  ``rint``, ``nearbyint``, ``exp10``, ``sinpi``, ``cospi``, ``tanpi`` and
  ``rootn`` of integers, alone and beside an f32 vector (weak and strong
  results), values within 1e-12;
* float-to-integer conversion, through ``cast`` and through an
  assignment into an integer vector: every float type (and the real part
  of a complex one) into every integer type, at NaN, the infinities,
  each limit of the target and its neighbours in the source type, -0.5
  and +-3.7: ``lax.convert_element_type``'s saturating values, exact.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _both(ctx1, tctx, fn, *arrays):
    """(JAX, port) values of ``fn(package, *vectors)`` over ``arrays``."""
    jr = vex.eval(fn(vex, *[vex.vector(data=a, context=ctx1)
                            for a in arrays]))
    tr = vt.eval(fn(vt, *[vt.vector(data=a, context=tctx) for a in arrays]))
    return np.asarray(jr), np.asarray(tr)


def _same(jr, tr):
    assert tr.dtype == jr.dtype
    np.testing.assert_array_equal(tr, jr)
    if jr.dtype.kind in "fc":
        np.testing.assert_array_equal(np.signbit(tr.real),
                                      np.signbit(jr.real))


DIV_OPS = {"floordiv": lambda m, a, b: a // b,
           "mod": lambda m, a, b: a % b,
           "fmod": lambda m, a, b: m.fmod(a, b)}


def _dividends(rng, dt):
    if dt == np.bool_:
        return rng.random(64) < 0.5, rng.random(64) < 0.5
    info = np.iinfo(dt)
    a = rng.integers(max(info.min, -1000), min(info.max, 1000), 64)
    b = rng.integers(-3 if info.min < 0 else 0, 4, 64)
    a, b = a.astype(dt), b.astype(dt)
    a[:6] = [5, 0, 1, info.max, info.min, info.min]
    b[:6] = [0, 0, 0, 0, 0, -1 if info.min < 0 else 0]
    return a, b


@pytest.mark.parametrize("op", sorted(DIV_OPS))
@pytest.mark.parametrize("dt", [np.int32, np.int64, np.uint32, np.bool_,
                                np.int8, np.uint8, np.uint16, np.uint64])
def test_integer_division_by_zero_matches_jax(ctx1, tctx, rng, op, dt):
    """``a // b``, ``a % b`` and ``fmod(a, b)`` with zero divisors: XLA's
    values (i32 x // 0 is -2, or -1 at x == 0; x % 0 and fmod(x, 0) are
    0; an unsigned x // 0 all ones; fmod of two booleans keeps x)."""
    a, b = _dividends(rng, dt)
    _same(*_both(ctx1, tctx, DIV_OPS[op], a, b))


def test_integer_division_by_zero_xla_values(ctx1, tctx):
    """The cases of the fault's report, with the values vexcl_tpu gives."""
    a = np.array([5, -3, 0, 1], np.int32)
    z = np.zeros(4, np.int32)
    for op in DIV_OPS.values():
        jr, tr = _both(ctx1, tctx, op, a, z)
        _same(jr, tr)
    jr, tr = _both(ctx1, tctx, DIV_OPS["floordiv"],
                   np.array([7, 0], np.uint32), np.zeros(2, np.uint32))
    _same(jr, tr)
    assert (tr == np.iinfo(np.uint32).max).all()


SPECIAL = [np.nan, -0.0, 0.0, np.inf, -np.inf, -3.5, 2.0, 1e-30]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["sign", "cbrt"])
def test_sign_and_cbrt_special_values_match_jax(ctx1, tctx, name, dt):
    """NaN at NaN and a zero with its sign, as ``jnp.sign``/``jnp.cbrt``."""
    x = np.array(SPECIAL, dt)
    jr, tr = _both(ctx1, tctx, lambda m, v: getattr(m, name)(v), x)
    if name == "sign":
        _same(jr, tr)
    else:
        assert tr.dtype == jr.dtype
        np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.signbit(tr), np.signbit(jr))


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
def test_sign_of_complex_matches_jax(ctx1, tctx, dt):
    """x/|x| part by part, 0 at 0, NaN + 0j at inf + 0j."""
    x = np.array([0.5 + 1.5j, -2.5 - 0.5j, 0j, 3 + 4j, complex(np.inf, 0),
                  complex(np.nan, 1), 1e-20 + 1e-20j], dt)
    jr, tr = _both(ctx1, tctx, lambda m, v: m.sign(v), x)
    assert tr.dtype == jr.dtype
    np.testing.assert_allclose(tr, jr, rtol=1e-6 if dt == np.complex64
                               else 1e-15, atol=0)


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("name", ["round", "rint", "nearbyint"])
def test_complex_rounding_matches_jax(ctx1, tctx, name, dt):
    """Each part rounded half to even: 0.5+1.5j -> 0+2j."""
    x = np.array([0.5 + 1.5j, 2.5 - 0.5j, -1.5 + 2.49j, 1e6 + 0.5j,
                  complex(np.inf, -0.5)], dt)
    _same(*_both(ctx1, tctx, lambda m, v: getattr(m, name)(v), x))


@pytest.mark.parametrize("name", ["ceil", "floor", "trunc"])
def test_complex_ceil_floor_trunc_raise(ctx1, tctx, name):
    x = np.array([0.5 + 1.5j, 2.5 - 0.5j], np.complex64)
    for m, c in ((vex, ctx1), (vt, tctx)):
        with pytest.raises(TypeError):
            m.eval(getattr(m, name)(m.vector(data=x, context=c)))


def _complex(rng, n, dt):
    """Values with ties in the real part, so the order reaches the
    imaginary parts."""
    re = rng.integers(-4, 5, n) * 0.5
    return (re + 1j * rng.normal(size=n)).astype(dt)


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["MIN", "MAX"])
def test_complex_min_max_matches_jax(ctx1, tctx, rng, kind, dt):
    """numpy's lexicographic extreme of complex values."""
    x = _complex(rng, 300, dt)
    want = vex.Reductor(getattr(vex, kind))(vex.vector(data=x, context=ctx1))
    got = vt.Reductor(getattr(vt, kind), context=tctx)(
        vt.vector(data=x, context=tctx))
    assert got == want
    got2 = vt.Reductor(getattr(vt, kind), context=tctx)(
        vt.vector(data=x, context=tctx) * 2)
    assert got2 == 2 * want


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
def test_complex_reduce_view_matches_jax(ctx1, tctx, rng, op, dt):
    """``reduce_view`` of complex values over each axis set."""
    shape = (6, 7)
    x = _complex(rng, 42, dt) * (0.5 if op == "prod" else 1.0)
    for axes in (0, 1, (0, 1)):
        jr = np.asarray(vex.eval(vex.reduce_view(
            op, vex.slicer(shape)[:, :](vex.vector(data=x, context=ctx1)),
            axes)))
        tr = np.asarray(vt.eval(vt.reduce_view(
            op, vt.slicer(shape)[:, :](vt.vector(data=x, context=tctx)),
            axes)))
        assert tr.dtype == jr.dtype
        if op in ("min", "max"):
            np.testing.assert_array_equal(tr, jr)
        else:
            tol = 1e-5 if dt == np.complex64 else 1e-12
            np.testing.assert_allclose(tr, jr, rtol=0,
                                       atol=tol * max(1, np.abs(jr).max()))


@pytest.mark.parametrize("dt", [np.int32, np.int64, np.uint8])
@pytest.mark.parametrize("name", ["pow", "pown", "powr"])
def test_integer_pow_builtins_match_jax(ctx1, tctx, rng, name, dt):
    """``pow`` of two integer vectors is integer (``jnp.power``); of an
    integer and a float, the float."""
    a = rng.integers(0, 6, 50).astype(dt)
    b = rng.integers(0, 4, 50).astype(dt)
    _same(*_both(ctx1, tctx, lambda m, x, y: getattr(m, name)(x, y), a, b))
    f = rng.random(50).astype(np.float32)
    jr, tr = _both(ctx1, tctx, lambda m, x, y: getattr(m, name)(x, y), a, f)
    assert tr.dtype == jr.dtype
    np.testing.assert_allclose(tr, jr, rtol=1e-6)


@pytest.mark.parametrize("dt", [np.int32, np.int16, np.float32])
@pytest.mark.parametrize("name", ["rint", "nearbyint", "exp10", "sinpi",
                                  "cospi", "tanpi", "rootn"])
def test_integer_result_types_match_jax(ctx1, tctx, rng, name, dt):
    """The type of each builtin of an integer (or f32) vector, alone and
    added to an f32 vector: ``rint``, ``nearbyint`` and ``exp10`` of an
    integer are a strong f64, ``sinpi``, ``cospi``, ``tanpi`` and
    ``rootn`` a weak one, as the JAX package's forms give."""
    a = rng.integers(1, 9, 40).astype(dt)
    y = rng.random(40).astype(np.float32)
    n = np.full(40, 3, dt)

    def alone(m, x, k):
        return (m.rootn(x, k) if name == "rootn" else getattr(m, name)(x))

    def beside(m, x, k, v):
        return alone(m, x, k) + v

    for f, args in ((alone, (a, n)), (beside, (a, n, y))):
        jr, tr = _both(ctx1, tctx, f, *args)
        assert tr.dtype == jr.dtype, (name, f.__name__)
        np.testing.assert_allclose(tr, jr, rtol=1e-12 if jr.dtype
                                   == np.float64 else 1e-6, atol=1e-12)


CAST_SOURCES = ["float16", "bfloat16", "float32", "float64", "complex64",
                "complex128"]
CAST_TARGETS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
                np.uint32, np.uint64]


def _cast_inputs(src: str, tgt) -> torch.Tensor:
    """Values of type ``src`` at the edges of ``tgt``'s range: NaN, the
    infinities, -0.5, +-3.7, values beyond the range, and each limit
    rounded to the source type with its neighbours there (a complex
    source: these as its real parts)."""
    real = {"complex64": torch.float32,
            "complex128": torch.float64}.get(src, getattr(torch, src))
    info = np.iinfo(tgt)
    inf = float("inf")
    lims = torch.tensor([float(info.min), float(info.max)],
                        dtype=torch.float64).to(real)
    x = torch.cat([torch.tensor([float("nan"), inf, -inf, -0.5, 3.7, -3.7,
                                 0.0, -0.0, 1e10, -1e10, 3e9], dtype=real),
                   lims, torch.nextafter(lims, torch.full_like(lims, inf)),
                   torch.nextafter(lims, torch.full_like(lims, -inf))])
    return torch.complex(x, x.flip(0)) if src.startswith("complex") else x


@pytest.mark.parametrize("tgt", CAST_TARGETS)
@pytest.mark.parametrize("src", CAST_SOURCES)
def test_float_to_integer_conversion_saturates_as_jax(ctx1, tctx, src, tgt):
    """``cast(tgt, x)`` and ``y[:] = x`` into a ``tgt`` vector give
    ``lax.convert_element_type``'s values: truncation, NaN 0, saturation
    at the limits (f32 2147483648.0 is INT32_MAX), negatives 0 unsigned."""
    import jax.numpy as jnp

    x = _cast_inputs(src, tgt)
    arr = (x.float().numpy().astype(jnp.bfloat16) if src == "bfloat16"
           else x.numpy())
    jv, tv = vex.vector(data=arr, context=ctx1), vt.vector(data=x,
                                                           context=tctx)
    jr = np.asarray(vex.eval(vex.cast(tgt, jv)))
    tr = np.asarray(vt.eval(vt.cast(tgt, tv)))
    assert tr.dtype == jr.dtype == tgt
    np.testing.assert_array_equal(tr, jr)
    ja = vex.vector(len(arr), dtype=tgt, context=ctx1)
    ta = vt.vector(len(arr), dtype=tgt, context=tctx)
    ja[:] = jv
    ta[:] = tv
    np.testing.assert_array_equal(ta.to_numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ta.to_numpy(), jr)


def test_float_to_int32_saturating_values(ctx1, tctx):
    """f32 at and beyond the i32 range into i32 through ``cast`` and an
    assignment, as vexcl_tpu gives them."""
    a = np.array([1e10, -1e10, np.nan, np.inf, -np.inf, 3.7, -3.7, 3e9],
                 np.float32)
    want = [2147483647, -2147483648, 0, 2147483647, -2147483648, 3, -3,
            2147483647]
    tv = vt.vector(data=a, context=tctx)
    assert vt.eval(vt.cast(np.int32, tv)).tolist() == want
    out = vt.vector(8, dtype=np.int32, context=tctx)
    out[:] = tv
    assert out.to_numpy().tolist() == want
    assert np.asarray(vex.eval(vex.cast(np.int32, vex.vector(
        data=a, context=ctx1)))).tolist() == want
