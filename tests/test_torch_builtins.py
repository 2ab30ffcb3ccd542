"""Parity of the builtin catalog with vexcl_tpu, name by input type.

The same seeded numpy inputs go through both packages on the CPU: the
JAX package's builtins evaluate them eagerly (jnp under x64), the port's
through an expression (``vt.eval``), whose plain PyTorch forms are the
versions its kernels are held against on the card.  For every catalog
entry and every input type (bool, the signed and unsigned integers,
f16, bf16, f32, f64) the result type must be jnp's, or both packages
refuse the type; values must agree: integers and booleans exactly, f32
within 1e-5 and f64 within 1e-12 of the largest magnitude (another libm).

Where ``vexcl_tpu`` computes another thing than OpenCL (ROADMAP.md §3,
"Reference-side faults") the port computes OpenCL's definition, and the
cases there hold it against a Python-integer oracle, not against the JAX
package: ``mad_hi`` (the JAX package adds c to a*b), ``mul_hi`` and
``mad_sat`` of 64-bit integers (it drops to 32 bits), ``rotate`` of
negative values (an arithmetic shift) and ``ilogb(0)``.  Parity cases
keep to the inputs where both definitions agree.  The pairs, sincos and
the geometric helpers are compared through both packages too.
"""

import zlib

import numpy as np
import pytest

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
from chip_smoke import BUILTIN_DOMAIN

N = 64
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
TYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
         np.uint16, np.uint32, np.uint64, np.float16, "bfloat16",
         np.float32, np.float64]

#: integer domains where the JAX package's integer arithmetic does not
#: wrap the way the port's does (ROADMAP.md §3: keep results in range)
INT_DOMAIN = {"pow": (0, 5), "powr": (0, 5), "pown": (0, 5),
              "ilogb": (1, 50)}
#: builtins whose integer operands may span the whole type
FULL_RANGE = ("popcount", "clz", "__popc", "__popcll", "add_sat",
              "sub_sat", "mul_hi", "mad_sat", "upsample", "hadd",
              "bitselect", "maxmag", "minmag", "min", "max", "step",
              "select", "any", "all", "sign")

#: (name, type) pairs on which the packages part on purpose: the JAX
#: package gives a value where OpenCL defines none, or a wrong one
#: (ROADMAP.md §3), and the port refuses the type or computes OpenCL's
#: definition (held by the oracle cases below)
DIVERGE = {("mad_hi", t) for t in TYPES} | {
    ("mul_hi", t) for t in (np.bool_, np.int64, np.uint64, np.float16,
                            "bfloat16", np.float32, np.float64)} | {
    ("mad_sat", np.int64), ("upsample", np.bool_), ("ilogb", np.bool_)} | {
    ("upsample", t) for t in (np.float16, "bfloat16", np.float32)} | {
    # jnp shifts booleans as integers (its hadd and rhadd of booleans are
    # i64), where the port keeps PyTorch's booleans (hadd is and, rhadd
    # refused as a subtraction); OpenCL defines both on integers only
    ("hadd", np.bool_), ("rhadd", np.bool_),
    # XLA multiplies by a boolean as a select: rint(1 / False) * False is
    # 0 there, NaN in IEEE arithmetic, which the port keeps
    ("remainder", np.bool_)}

#: (name, type) pairs compared by type only: XLA's f64 log2 on the CPU is
#: not exact at powers of two (log2(8.0) = 2.9999999999999996), so
#: ``logb`` of the integers 8, 64, ... computed in f64 is one less there
TYPE_ONLY = {("logb", np.int64), ("logb", np.uint64)}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _np_type(t):
    if t == "bfloat16":
        import ml_dtypes

        return ml_dtypes.bfloat16
    return t


def _data(name, t, k, rng):
    """Operand k of ``name`` in type t."""
    t = _np_type(t)
    if t == np.bool_:
        return rng.random(N) < 0.5
    if np.dtype(t).kind in "iu":
        info = np.iinfo(t)
        if name == "rotate":
            # non-negative values, shifts within the width: where the JAX
            # package's arithmetic shift equals the logical one
            hi = info.max if k == 0 else info.bits - 1
            return rng.integers(0, hi, N, dtype=t, endpoint=True)
        if name in FULL_RANGE:
            return rng.integers(info.min, info.max, N, dtype=t, endpoint=True)
        lo, hi = INT_DOMAIN.get(name, (-50, 50))
        return rng.integers(max(lo, info.min), hi, N).astype(t)
    if name == "ldexp" and k == 1:
        return rng.integers(-20, 20, N).astype(np.int32)
    lo, hi = BUILTIN_DOMAIN.get(name, (-3, 3))
    return (lo + (hi - lo) * rng.random(N)).astype(t)


def _jax_all(name, cases):
    """The JAX package's results for each case (a list of operand
    arrays), None where it refuses the types: the types traced case by
    case, the values of all accepted cases from one jitted call (eager
    operations and a compile per case are far slower on the CPU)."""
    import jax

    fn = vex.BUILTINS[name]
    ok = []
    for arrays in cases:
        try:
            jax.eval_shape(fn, *[jax.ShapeDtypeStruct(a.shape, a.dtype)
                                 for a in arrays])
            ok.append(True)
        except (TypeError, ValueError, OverflowError, KeyError):
            ok.append(False)
    vals = iter(jax.jit(lambda cs: [fn(*a) for a in cs])(
        [a for a, k in zip(cases, ok) if k]))
    return [np.asarray(next(vals)) if k else None for k in ok]


def _port(name, arrays, tctx):
    import torch

    try:
        r = vt.eval(vt.BUILTINS[name](*[vt.vector(data=a, context=tctx)
                                        for a in arrays]))
    except (TypeError, RuntimeError):
        return None
    return np.asarray(r.float() if r.dtype == torch.bfloat16 else r)


def _close(got, want, rtol):
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(1.0, np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("name", KERNEL_BUILTINS)
def test_builtin_types_and_values(ctx1, tctx, name):
    """Result type by input type, and the values (f16 and bf16: the type
    only), against vexcl_tpu."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    cases = [[_data(name, t, k, rng) for k in range(vt.BUILTINS[name].nargs)]
             for t in TYPES]
    for t, arrays, want in zip(TYPES, cases, _jax_all(name, cases)):
        typed = t in (np.float16, "bfloat16") or (name, t) in TYPE_ONLY
        got = _port(name, arrays, tctx)
        if want is None or (name, t) in DIVERGE:
            # jnp refuses the type (the port may compute it in its
            # compute type), or the packages part on purpose
            continue
        assert got is not None, (name, t)
        if typed:
            if want.dtype.name != "bfloat16":
                assert got.dtype == want.dtype, (name, t)
            continue
        assert got.dtype == want.dtype, (name, t, got.dtype, want.dtype)
        _close(got, want, RTOL[np.float32] if want.dtype == np.float32
               else RTOL[np.float64])


def test_every_public_name_of_vexcl_tpu_is_in_the_port():
    """Every public name of vexcl_tpu (its module names and the lazy ones
    of its ``__getattr__``) is a name of the port, except the
    multi-device ``parallel``, ``set_partitioning`` and
    ``reset_partitioning``; and every catalog entry has a kernel form."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(vex))
    lazy = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_lazy" for t in node.targets):
            lazy = {k.value for k in node.value.keys}
    assert {"image1d", "image2d", "svm_vector"} <= lazy
    names = {n for n in dir(vex) if not n.startswith("_")} | lazy
    missing = sorted(n for n in names if not hasattr(vt, n))
    assert missing == ["parallel", "reset_partitioning", "set_partitioning"]
    assert set(vex.BUILTINS) == set(vt.BUILTINS)
    assert hasattr(vt.Filter, "Exclusive")
    assert all(b.kernel_form is not None for b in vt.BUILTINS.values())


# -- the reference-side faults: OpenCL's definitions, against Python
# integers --------------------------------------------------------------

def _ints(values, dt):
    return np.array(values, dtype=object).astype(dt)


def _signed(v, bits):
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _mul_hi_oracle(a, b, bits, signed):
    p = int(a) * int(b)
    return _signed(p >> bits, bits) if signed else (p >> bits) & (
        (1 << bits) - 1)


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.int64,
                                np.uint8, np.uint16, np.uint32, np.uint64])
def test_mul_hi_mad_hi_mad_sat_oracle(tctx, dt):
    """mul_hi from the full product, mad_hi = mul_hi(a, b) + c (wrapping)
    and mad_sat saturating the exact a*b + c, every integer type; the
    JAX package's mul_hi of i64 (1 << 40, 1 << 40) gives 0 and its
    mad_hi(3, 5, 1) 16."""
    info = np.iinfo(dt)
    bits, signed = info.bits, info.min < 0
    rng = np.random.default_rng(7)
    a = rng.integers(info.min, info.max, 200, dtype=dt, endpoint=True)
    b = rng.integers(info.min, info.max, 200, dtype=dt, endpoint=True)
    c = rng.integers(info.min, info.max, 200, dtype=dt, endpoint=True)
    a[:4] = _ints([info.max, info.min, 3, min(1 << 40, info.max)], dt)
    b[:4] = _ints([info.max, info.min, 5, min(1 << 40, info.max)], dt)
    c[:4] = _ints([info.max, info.min, 1, 0], dt)
    va, vb, vc = (vt.vector(data=x, context=tctx) for x in (a, b, c))
    hi = np.asarray(vt.eval(vt.mul_hi(va, vb)))
    mh = np.asarray(vt.eval(vt.mad_hi(va, vb, vc)))
    ms = np.asarray(vt.eval(vt.mad_sat(va, vb, vc)))
    assert hi.dtype == mh.dtype == ms.dtype == np.dtype(dt)
    for i in range(len(a)):
        h = _mul_hi_oracle(a[i], b[i], bits, signed)
        assert int(hi[i]) == h, (i, a[i], b[i])
        want = _signed(h + int(c[i]), bits) if signed else (
            h + int(c[i])) & ((1 << bits) - 1)
        assert int(mh[i]) == want
        exact = int(a[i]) * int(b[i]) + int(c[i])
        assert int(ms[i]) == min(max(exact, int(info.min)), int(info.max))
    if bits == 64 and signed:
        assert int(hi[3]) == 65536
    assert vt.mad_hi(3, 5, 1) == 1


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.int64,
                                np.uint8, np.uint16, np.uint32, np.uint64])
def test_rotate_oracle(tctx, dt):
    """rotate is a left rotation by s modulo the width, for negative
    values and shifts too (the JAX package's rotate(-8, 4) in i32 is -1,
    OpenCL's -113)."""
    info = np.iinfo(dt)
    bits = info.bits
    rng = np.random.default_rng(8)
    x = rng.integers(info.min, info.max, 200, dtype=dt, endpoint=True)
    s = rng.integers(info.min, info.max, 200, dtype=dt, endpoint=True)
    if info.min < 0:
        x[0], s[0] = -8, 4
    got = np.asarray(vt.eval(vt.rotate(vt.vector(data=x, context=tctx),
                                       vt.vector(data=s, context=tctx))))
    for i in range(len(x)):
        v, k = int(x[i]) & ((1 << bits) - 1), int(s[i]) % bits
        r = ((v << k) | (v >> (bits - k))) & ((1 << bits) - 1)
        want = _signed(r, bits) if info.min < 0 else r
        assert int(got[i]) == want, (x[i], s[i])
    if dt == np.int32:
        assert int(got[0]) == -113


def test_ilogb_oracle(tctx):
    """ilogb: the unbiased exponent (subnormals included); INT_MIN at 0
    and NaN, INT_MAX at infinity (the JAX package gives -1 at 0)."""
    import math

    for dt in (np.float32, np.float64):
        x = np.array([0.0, -0.0, 1.0, 0.75, -3.0, 1e-40, 1e30, np.inf,
                      -np.inf, np.nan], dtype=dt)
        got = np.asarray(vt.eval(vt.ilogb(vt.vector(data=x, context=tctx))))
        assert got.dtype == np.int32
        want = [math.frexp(float(v))[1] - 1 if np.isfinite(v) and v != 0
                else -(1 << 31) if v == 0 or np.isnan(v) else (1 << 31) - 1
                for v in x]
        assert got.tolist() == want, dt


def test_integer_pow_and_boolean_arithmetic(ctx1, tctx):
    """Integer ** wraps as integer arithmetic does (2 ** -3 is 0, 3 ** 100
    in i32 is 3^100 mod 2^32 as signed); parity with vexcl_tpu at
    exponents >= 0 with results in range; + and * of booleans are or
    and and, as jnp gives them."""
    a = vt.vector(data=np.array([2, -1, 1, 3, -2, 0], np.int32),
                  context=tctx)
    b = vt.vector(data=np.array([-3, -3, -5, 100, 3, 0], np.int32),
                  context=tctx)
    got = np.asarray(vt.eval(a ** b)).tolist()
    assert got == [0, -1, 1, _signed(pow(3, 100, 1 << 32), 32), -8, 1]
    rng = np.random.default_rng(9)
    for dt in (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint32):
        x = rng.integers(0, 4, N).astype(dt)
        e = rng.integers(0, 5, N).astype(dt)
        want = np.asarray(vex.eval(vex.vector(data=x, context=ctx1)
                                   ** vex.vector(data=e, context=ctx1)))
        got = np.asarray(vt.eval(vt.vector(data=x, context=tctx)
                                 ** vt.vector(data=e, context=tctx)))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    p, q = rng.random(N) < 0.5, rng.random(N) < 0.5
    for fn in (lambda m, u, v: u + v, lambda m, u, v: u * v,
               lambda m, u, v: m.mad(u, v, u), lambda m, u, v: m.max(u, v),
               lambda m, u, v: m.clamp(u, v, u), lambda m, u, v: u < v,
               lambda m, u, v: u ** v, lambda m, u, v: u // v):
        want = np.asarray(vex.eval(fn(vex, vex.vector(data=p, context=ctx1),
                                      vex.vector(data=q, context=ctx1))))
        got = np.asarray(vt.eval(fn(vt, vt.vector(data=p, context=tctx),
                                    vt.vector(data=q, context=tctx))))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- pairs, sincos, the geometric helpers, shuffle ---------------------------

def test_pairs_geometric_and_shuffle(ctx1, tctx):
    """sincos, modf, frexp, remquo and lgamma_r (pairs of expressions,
    assigned through ``tie``), dot, length, distance, normalize, cross,
    the fast_ forms and shuffle/shuffle2 over multivectors."""
    rng = np.random.default_rng(10)
    h = [(rng.random(N) * 6 - 3) for _ in range(6)]
    jv = [vex.vector(data=a, context=ctx1) for a in h]
    tv = [vt.vector(data=a, context=tctx) for a in h]

    def pair(m, vs, fn):
        outs = [m.vector(N, dtype=np.float64, context=vs[0].context)
                for _ in range(2)]
        if fn == "frexp":
            outs[1] = m.vector(N, dtype=np.int32, context=vs[0].context)
        if fn == "lgamma_r":
            outs[1] = m.vector(N, dtype=np.int64, context=vs[0].context)
        args = vs[:2] if fn == "remquo" else vs[:1]
        m.tie(*outs).assign(getattr(m, fn)(*args))
        return [np.asarray(o.to_numpy() if m is vt else o) for o in outs]

    for fn in ("sincos", "modf", "frexp", "remquo", "lgamma_r"):
        for w, g in zip(pair(vex, jv, fn), pair(vt, tv, fn)):
            _close(g, w, RTOL[np.float64])

    jm = vex.multivector(N, 3, dtype=np.float64, context=ctx1)
    tm = vt.multivector(N, 3, dtype=np.float64, context=tctx)
    jm2 = vex.multivector(N, 3, dtype=np.float64, context=ctx1)
    tm2 = vt.multivector(N, 3, dtype=np.float64, context=tctx)
    for i in range(3):
        jm(i)[:] = jv[i]
        tm(i)[:] = tv[i]
        jm2(i)[:] = jv[i + 3]
        tm2(i)[:] = tv[i + 3]
    for fn in (lambda m, a, b: m.dot(a, b), lambda m, a, b: m.length(a),
               lambda m, a, b: m.distance(a, b),
               lambda m, a, b: m.fast_length(a),
               lambda m, a, b: m.fast_distance(a, b)):
        want = np.asarray(vex.eval(fn(vex, jm, jm2)))
        got = np.asarray(vt.eval(fn(vt, tm, tm2)))
        _close(got, want, RTOL[np.float64])
    for fn in (lambda m, a, b: m.normalize(a), lambda m, a, b: m.cross(a, b),
               lambda m, a, b: m.fast_normalize(b),
               lambda m, a, b: m.shuffle(a, [2, 0, 1]),
               lambda m, a, b: m.shuffle2(a, b, [5, 0, 3])):
        jo = vex.multivector(N, 3, dtype=np.float64, context=ctx1)
        to = vt.multivector(N, 3, dtype=np.float64, context=tctx)
        jo[:] = fn(vex, jm, jm2)
        to[:] = fn(vt, tm, tm2)
        for i in range(3):
            _close(to(i).to_numpy(), np.asarray(jo(i)), RTOL[np.float64])
    # tuples of expressions are components too
    want = np.asarray(vex.eval(vex.dot((jv[0], jv[1]), (jv[2], jv[3]))))
    got = np.asarray(vt.eval(vt.dot((tv[0], tv[1]), (tv[2], tv[3]))))
    _close(got, want, RTOL[np.float64])
