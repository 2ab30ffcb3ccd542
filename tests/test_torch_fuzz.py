"""Seeded fuzz parity of the PyTorch port with vexcl_tpu, on the CPU.

Small, seeded versions of ``exp/fuzz_expressions.py`` and
``exp/fuzz_algorithms.py``: each
seed draws a few dozen recipes with numpy, and every recipe is built and
evaluated through both packages' public APIs.

* Float trees: f32 vectors, weak Python scalars, builtins of plain
  numbers (``pow(fabs(c) + 0.5, x)``), 0-d f32 and f64 tensors (strongly
  typed, as a 0-d jnp array is), ``element_index``; assigned into an f32
  vector and summed.  Seeds from 3 on put special values in the vectors
  (NaN, ±0, ±inf; normal numbers only, as the JAX package on the CPU
  flushes subnormals: ``sign`` and ``fmod`` take whole numbers, which a
  subnormal result does not change), which ``sign``, ``cbrt`` and
  ``fmod`` (zero divisors) meet.  Tolerance: ten times the rounding headroom of the
  tree (a numpy f32 evaluation against an f64 one, the fuzzer's own
  measure) plus 1e-4 of the magnitude, the same places not finite;
  result types must agree.
* Integer trees: u32 vectors with values above 2^31, u64 vectors with
  values at and above 2^63, i32 and i64 vectors, each with zeros, -1 and
  the extremes at random places, and boolean vectors, through the
  operators the CPU could not compute on them before (``+ - * // % <<
  >>``, compares, ``min``/``max``, ``abs``, ``where``), ``//``, ``%`` and
  ``fmod`` by divisors with zeros, ``pow`` of two integers, and ``rint``
  of a whole tree (the default float type); exact, result types must
  agree; MIN, MAX and SUM of each.
* Complex trees: c64 and c128 vectors of halves (so that sums, products
  and their rounding are exact in both packages) through ``+ - *``,
  ``conj``, ``round``, ``rint`` and ``sign`` (at the root); their MIN,
  MAX (numpy's lexicographic order, with ties in the real parts) and
  SUM.  Exact, ``sign`` and SUM within 1e-6 (c64) / 1e-12 (c128) of the
  magnitude.
* Algorithms: ``sort``, ``sort_by_key``, the scans, ``scan_by_key`` and
  ``reduce_by_key`` over the fuzzer's key patterns (all equal, all
  distinct, runs, alternating, random) at a tiny and two odd sizes (each
  size one compile of the JAX package's kernels: the file stays near
  15 s); keys and
  counts exact, sums within 2e-5 of the magnitude (f32, two summation
  orders); ``vex.fft`` of c64 inputs at the same sizes within 5e-6 of the
  largest magnitude of numpy's c128 transform (the fuzzer's bound) and of
  the JAX package's.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt

SEEDS = (0, 1, 2)
#: seeds of float trees whose vectors hold special values
SPECIAL_SEEDS = (3, 4, 5)
N = 257


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


# -- float trees -------------------------------------------------------------

BINOPS = [
    (lambda m, a, b: a + b, lambda a, b: a + b),
    (lambda m, a, b: a - b, lambda a, b: a - b),
    (lambda m, a, b: a * b, lambda a, b: a * b),
    (lambda m, a, b: a / (b * b + 1.0), lambda a, b: a / (b * b + 1.0)),
    (lambda m, a, b: m.fmax(a, b), np.fmax),
    (lambda m, a, b: m.fmin(a, b), np.fmin),
    (lambda m, a, b: m.pow(m.fabs(a) + 0.5, b),
     lambda a, b: np.power(np.abs(a) + 0.5, b)),
    # whole divisors (zero where |b| < 1): a tree's own results may
    # underflow to subnormals, which the JAX package flushes to zero
    (lambda m, a, b: m.fmod(a, m.trunc(b)), lambda a, b: np.fmod(
        a, np.trunc(b))),
]
UNOPS = [
    (lambda m, e: m.sin(m.fmin(m.fmax(e, -30.0), 30.0)),
     lambda a: np.sin(np.clip(a, -30.0, 30.0))),
    (lambda m, e: m.exp(m.fmin(m.fmax(e, -20.0), 20.0)),
     lambda a: np.exp(np.clip(a, -20.0, 20.0))),
    (lambda m, e: m.sqrt(m.fabs(e)), lambda a: np.sqrt(np.abs(a))),
    (lambda m, e: m.tanh(e), np.tanh),
    (lambda m, e: -e, lambda a: -a),
    (lambda m, e: 2.5 * e + 1.0, lambda a: 2.5 * a + 1.0),
    (lambda m, e: m.sign(m.trunc(e * 4.0)),
     lambda a: np.sign(np.trunc(a * 4.0))),
    (lambda m, e: m.cbrt(e), np.cbrt),
]
#: the special values of the special seeds' vectors
SPECIALS = (np.nan, -0.0, 0.0, np.inf, -np.inf)


def float_recipe(rng, depth):
    """A random tree as nested tuples: ("v", i), ("c", float), ("t", float,
    dtype) a 0-d tensor, ("idx",), ("u", k, sub), ("b", k, sub, sub)."""
    if depth == 0 or rng.random() < 0.25:
        r = rng.random()
        if r < 0.5:
            return ("v", int(rng.integers(0, 3)))
        if r < 0.7:
            return ("c", float(rng.normal()))
        if r < 0.9:
            return ("t", float(rng.normal()),
                    (np.float32, np.float64)[int(rng.integers(0, 2))])
        return ("idx",)
    if rng.random() < 0.5:
        return ("u", int(rng.integers(0, len(UNOPS))),
                float_recipe(rng, depth - 1))
    return ("b", int(rng.integers(0, len(BINOPS))),
            float_recipe(rng, depth - 1), float_recipe(rng, depth - 1))


def build(recipe, m, vecs, zero_d):
    """The tree of ``recipe`` in package ``m`` over ``vecs``; 0-d leaves
    through ``zero_d(value, dtype)``."""
    kind = recipe[0]
    if kind == "v":
        return vecs[recipe[1]]
    if kind == "c":
        return recipe[1]
    if kind == "t":
        return zero_d(recipe[1], recipe[2])
    if kind == "idx":
        return m.element_index(0, N) * 1.0
    if kind == "u":
        return UNOPS[recipe[1]][0](m, build(recipe[2], m, vecs, zero_d))
    return BINOPS[recipe[1]][0](m, build(recipe[2], m, vecs, zero_d),
                                build(recipe[3], m, vecs, zero_d))


@np.errstate(all="ignore")
def oracle(recipe, arrs, dt):
    kind = recipe[0]
    if kind == "v":
        return arrs[recipe[1]].astype(dt)
    if kind in ("c", "t"):
        return dt(recipe[1]) if kind == "c" else dt(recipe[2](recipe[1]))
    if kind == "idx":
        return np.arange(N, dtype=dt)
    if kind == "u":
        return dt(UNOPS[recipe[1]][1](oracle(recipe[2], arrs, dt)))
    return dt(BINOPS[recipe[1]][1](oracle(recipe[2], arrs, dt),
                                   oracle(recipe[3], arrs, dt)))


def _sized(recipe) -> bool:
    return recipe[0] in ("v", "idx") or any(
        _sized(r) for r in recipe[2:] if isinstance(r, tuple))


def _has_vector(recipe) -> bool:
    return recipe[0] == "v" or any(
        _has_vector(r) for r in recipe[2:] if isinstance(r, tuple))


@pytest.mark.parametrize("seed", SEEDS + SPECIAL_SEEDS)
def test_expression_fuzz(seed, ctx1, tctx):
    """Random float trees, assigned and summed, through both packages."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=N).astype(np.float32) for _ in range(3)]
    if seed in SPECIAL_SEEDS:
        for a in arrs:
            a[rng.choice(N, 3 * len(SPECIALS), replace=False)] = np.repeat(
                SPECIALS, 3)
    jv = [vex.vector(data=a, context=ctx1) for a in arrs]
    tv = [vt.vector(data=a, context=tctx) for a in arrs]
    trees = 0
    while trees < 24:
        recipe = float_recipe(rng, int(rng.integers(1, 5)))
        if not _sized(recipe):
            continue
        trees += 1
        je = build(recipe, vex, jv, lambda c, dt: jnp.asarray(dt(c)))
        te = build(recipe, vt, tv, lambda c, dt: torch.tensor(dt(c)))
        jo = vex.vector(N, dtype=np.float32, context=ctx1)
        to = vt.vector(N, dtype=np.float32, context=tctx)
        jo[:] = je
        to[:] = te
        jr, tr = jo.to_numpy().astype(np.float64), to.to_numpy()
        ref = np.broadcast_to(oracle(recipe, arrs, np.float64), (N,))
        cond = np.abs(np.broadcast_to(oracle(recipe, arrs, np.float32),
                                      (N,)) - ref)
        ok = np.isfinite(jr) & np.isfinite(cond) & (np.abs(jr) < 1e30)
        tol = 10.0 * cond[ok] + 1e-4 * np.maximum(np.abs(jr[ok]), 1.0)
        assert np.array_equal(np.isfinite(jr), np.isfinite(tr)), recipe
        assert (np.abs(tr[ok] - jr[ok]) <= tol).all(), recipe
        # every third tree, the evaluated value's own type (a tree over no
        # vector has no context to evaluate in); every other, its sum
        # (each a compile of the JAX package's)
        if trees % 3 == 0 and _has_vector(recipe):
            assert (np.asarray(vt.eval(te)).dtype
                    == np.asarray(vex.eval(je)).dtype), recipe
        if trees % 2 == 0 and ok.all() and np.abs(jr).max() < 1e12:
            js = vex.Reductor(vex.SUM)(je)
            ts = vt.Reductor(vt.SUM, context=tctx)(te)
            slack = 10.0 * cond.sum() + 1e-4 * max(1.0, abs(js)) + 0.3
            assert abs(ts - js) <= slack, (recipe, ts, js)


# -- integer and boolean trees -----------------------------------------------

INT_BINOPS = [
    lambda m, a, b: a + b,
    lambda m, a, b: a - b,
    lambda m, a, b: a * b,
    lambda m, a, b: a // (b | 1),
    lambda m, a, b: a % (b | 1),
    lambda m, a, b: a & b,
    lambda m, a, b: a ^ b,
    lambda m, a, b: m.min(a, b),
    lambda m, a, b: m.max(a, b),
    lambda m, a, b: m.if_else(a < b, a, b),
    lambda m, a, b: m.if_else(a >= b, b, a | b),
    lambda m, a, b: a // b,
    lambda m, a, b: a % b,
    lambda m, a, b: m.fmod(a, b),
    lambda m, a, b: m.pow(a & 7, b & 3),
]
INT_UNOPS = [
    lambda m, e: e >> 3,
    lambda m, e: e << 5,
    lambda m, e: -e,
    lambda m, e: ~e,
    lambda m, e: abs(e),
    lambda m, e: e * 3 + 7,
]
BOOL_OPS = [
    lambda m, b, t: abs(b),
    lambda m, b, t: b // t,
    lambda m, b, t: b % t,
    lambda m, b, t: b << b,
    lambda m, b, t: b >> t,
    lambda m, b, t: (b & t) | b,
    lambda m, b, t: m.if_else(b, t, b),
    lambda m, b, t: m.min(b, t),
    lambda m, b, t: b // b,
    lambda m, b, t: b % b,
    lambda m, b, t: m.fmod(b, b),
    lambda m, b, t: m.fmod(t, b),
    lambda m, b, t: m.fmod(t, b * 1),
]


def int_arrays(rng, dtype):
    if dtype == np.uint64:
        hi = rng.integers(0, 1 << 62, N, dtype=np.uint64) * np.uint64(4)
        a = hi + rng.integers(0, 4, N, dtype=np.uint64)
        a[:4] = [1 << 63, (1 << 64) - 1, (1 << 63) + 5, 0]
    elif dtype == np.uint32:
        a = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
        a[:3] = [1 << 31, (1 << 32) - 1, (1 << 31) + 7]
    else:
        a = rng.integers(-(1 << 30), 1 << 30, N).astype(dtype)
    # zero divisors, -1 and the extremes at random places
    info = np.iinfo(dtype)
    special = [0] * 8 + [1, info.max] + ([-1, info.min] if info.min else [])
    a[rng.choice(N, len(special), replace=False)] = special
    return a


def int_recipe(rng, depth):
    if depth == 0 or rng.random() < 0.3:
        return ("v", int(rng.integers(0, 2)))
    if rng.random() < 0.4:
        return ("u", int(rng.integers(0, len(INT_UNOPS))),
                int_recipe(rng, depth - 1))
    return ("b", int(rng.integers(0, len(INT_BINOPS))),
            int_recipe(rng, depth - 1), int_recipe(rng, depth - 1))


def build_int(recipe, m, vecs):
    if recipe[0] == "v":
        return vecs[recipe[1]]
    if recipe[0] == "u":
        return INT_UNOPS[recipe[1]](m, build_int(recipe[2], m, vecs))
    return INT_BINOPS[recipe[1]](m, build_int(recipe[2], m, vecs),
                                 build_int(recipe[3], m, vecs))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int32,
                                   np.int64])
def test_integer_fuzz(seed, dtype, ctx1, tctx):
    """Random integer trees over u32 (values above 2^31), u64 (values at
    and above 2^63), i32 and i64 vectors with zeros, -1 and the extremes,
    evaluated, and their MIN, MAX, SUM: exact, of one type in both
    packages."""
    rng = np.random.default_rng(100 + seed)
    arrs = [int_arrays(rng, dtype) for _ in range(2)]
    jv = [vex.vector(data=a, context=ctx1) for a in arrs]
    tv = [vt.vector(data=a, context=tctx) for a in arrs]
    for k in range(8):
        recipe = int_recipe(rng, int(rng.integers(1, 4)))
        je, te = build_int(recipe, vex, jv), build_int(recipe, vt, tv)
        if k == 7:      # an integer tree made the default float type
            je, te = vex.rint(je), vt.rint(te)
        jr, tr = np.asarray(vex.eval(je)), np.asarray(vt.eval(te))
        assert tr.dtype == jr.dtype, recipe
        np.testing.assert_array_equal(tr, jr, err_msg=str(recipe))
    for kind in ("MIN", "MAX", "SUM"):
        expr_j, expr_t = jv[0] ^ jv[1], tv[0] ^ tv[1]
        assert (vt.Reductor(getattr(vt, kind))(expr_t)
                == vex.Reductor(getattr(vex, kind))(expr_j)), kind


@pytest.mark.parametrize("seed", SEEDS)
def test_boolean_fuzz(seed, ctx1, tctx):
    """Boolean vectors through the operators the CPU lacked (abs, //, %,
    <<, >>) and the rest, with the JAX package's result types, and their
    MIN and MAX."""
    rng = np.random.default_rng(200 + seed)
    b = rng.random(N) < 0.5
    t = np.ones(N, dtype=bool)          # a divisor that is never 0
    jb, jt = (vex.vector(data=a, context=ctx1) for a in (b, t))
    tb, tt = (vt.vector(data=a, context=tctx) for a in (b, t))
    for op in BOOL_OPS:
        jr = np.asarray(vex.eval(op(vex, jb, jt)))
        tr = np.asarray(vt.eval(op(vt, tb, tt)))
        assert tr.dtype == jr.dtype
        np.testing.assert_array_equal(tr, jr)
    for kind in ("MIN", "MAX"):
        assert (vt.Reductor(getattr(vt, kind))(tb)
                == vex.Reductor(getattr(vex, kind))(jb))


# -- complex trees -----------------------------------------------------------

CPLX_BINOPS = [lambda m, a, b: a + b, lambda m, a, b: a - b,
               lambda m, a, b: a * b]
CPLX_UNOPS = [lambda m, e: m.conj(e), lambda m, e: m.round(e * 0.5),
              lambda m, e: m.rint(e * 0.5) - e]


def complex_recipe(rng, depth):
    if depth == 0 or rng.random() < 0.3:
        return ("v", int(rng.integers(0, 3)))
    if rng.random() < 0.4:
        return ("u", int(rng.integers(0, len(CPLX_UNOPS))),
                complex_recipe(rng, depth - 1))
    return ("b", int(rng.integers(0, len(CPLX_BINOPS))),
            complex_recipe(rng, depth - 1), complex_recipe(rng, depth - 1))


def build_complex(recipe, m, vecs):
    if recipe[0] == "v":
        return vecs[recipe[1]]
    if recipe[0] == "u":
        return CPLX_UNOPS[recipe[1]](m, build_complex(recipe[2], m, vecs))
    return CPLX_BINOPS[recipe[1]](m, build_complex(recipe[2], m, vecs),
                                  build_complex(recipe[3], m, vecs))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_fuzz(seed, dtype, ctx1, tctx):
    """Random complex trees over vectors of halves (exact arithmetic),
    with ``sign`` at the root of every other one, evaluated, and their
    MIN, MAX and SUM, through both packages."""
    rng = np.random.default_rng(500 + seed)
    arrs = [(rng.integers(-4, 5, N) * 0.5
             + 1j * rng.integers(-4, 5, N) * 0.5).astype(dtype)
            for _ in range(3)]
    arrs[0][:4] = 0
    jv = [vex.vector(data=a, context=ctx1) for a in arrs]
    tv = [vt.vector(data=a, context=tctx) for a in arrs]
    tol = 1e-6 if dtype == np.complex64 else 1e-12
    for k in range(8):
        recipe = complex_recipe(rng, int(rng.integers(1, 4)))
        je, te = build_complex(recipe, vex, jv), build_complex(recipe, vt, tv)
        if k % 2:
            je, te = vex.sign(je), vt.sign(te)
        jr, tr = np.asarray(vex.eval(je)), np.asarray(vt.eval(te))
        assert tr.dtype == jr.dtype, recipe
        if k % 2:
            np.testing.assert_allclose(tr, jr, rtol=0, atol=tol,
                                       err_msg=str(recipe))
            continue
        np.testing.assert_array_equal(tr, jr, err_msg=str(recipe))
        for kind in ("MIN", "MAX"):
            assert (vt.Reductor(getattr(vt, kind), context=tctx)(te)
                    == vex.Reductor(getattr(vex, kind))(je)), (kind, recipe)
        js = vex.Reductor(vex.SUM)(je)
        ts = vt.Reductor(vt.SUM, context=tctx)(te)
        assert abs(ts - js) <= tol * max(1.0, np.abs(jr).sum()), recipe


# -- algorithms --------------------------------------------------------------

SIZES = (3, 129, 1003)
MODES = ("equal", "distinct", "runs", "alt", "rand")


def keys_for(rng, n, mode):
    if mode == "equal":
        return np.full(n, 7, np.int32)
    if mode == "distinct":
        return rng.permutation(n).astype(np.int32)
    if mode == "runs":
        run = max(1, n // max(1, int(rng.integers(1, 64))))
        return (np.arange(n) // run).astype(np.int32)
    if mode == "alt":
        return (np.arange(n) % 2).astype(np.int32)
    return rng.integers(0, max(2, n // 4), n).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("seed", SEEDS)
def test_algorithm_fuzz(seed, ctx1, tctx):
    """sort, sort_by_key, the scans, scan_by_key and reduce_by_key at odd
    and tiny sizes over the fuzzer's key patterns, through both
    packages."""
    rng = np.random.default_rng(300 + seed)
    for n in SIZES:
        mode = MODES[int(rng.integers(0, len(MODES)))]
        k = keys_for(rng, n, mode)
        v = rng.random(n).astype(np.float32)
        pair = {}
        for name, m, c in (("j", vex, ctx1), ("t", vt, tctx)):
            kv, vv = (m.vector(data=a, context=c) for a in (k, v))
            m.sort_by_key(kv, vv)
            ks = m.vector(data=k, context=c)
            m.sort(ks)
            sk = np.sort(k)
            skv = m.vector(data=sk, context=c)
            vv2 = m.vector(data=v, context=c)
            ko, vo, cnt = m.reduce_by_key(skv, vv2)
            pair[name] = dict(
                sbk=(kv.to_numpy().copy(), vv.to_numpy().copy()),
                sort=ks.to_numpy().copy(),
                scan=m.inclusive_scan(vv2).to_numpy().copy(),
                exscan=m.exclusive_scan(vv2).to_numpy().copy(),
                segscan=m.inclusive_scan_by_key(skv, vv2).to_numpy().copy(),
                rbk=(int(cnt), ko.to_numpy()[:cnt].copy(),
                     vo.to_numpy()[:cnt].copy()))
        j, t = pair["j"], pair["t"]
        np.testing.assert_array_equal(t["sort"], j["sort"])
        np.testing.assert_array_equal(t["sbk"][0], j["sbk"][0])
        np.testing.assert_array_equal(t["sbk"][1], j["sbk"][1])
        for name in ("scan", "exscan", "segscan"):
            _close(t[name], j[name])
        assert t["rbk"][0] == j["rbk"][0], (n, mode)
        np.testing.assert_array_equal(t["rbk"][1], j["rbk"][1])
        _close(t["rbk"][2], j["rbk"][2])


@pytest.mark.parametrize("seed", SEEDS)
def test_fft_fuzz(seed, ctx1, tctx):
    """``fft`` of c64 vectors at the fuzzer's sizes (a prime and odd
    lengths) through both packages against numpy's c128 transform."""
    rng = np.random.default_rng(400 + seed)
    for n in SIZES:
        x = (rng.random(n) + 1j * rng.random(n)).astype(np.complex64)
        ref = np.fft.fft(x.astype(np.complex128))
        scale = max(1e-30, np.abs(ref).max())
        out = vt.vector(n, dtype=np.complex64, context=tctx)
        out[:] = vt.fft(vt.vector(data=x, context=tctx))
        got = out.to_numpy()
        jout = vex.vector(n, dtype=np.complex64, context=ctx1)
        jout[:] = vex.fft(vex.vector(data=x, context=ctx1))
        assert np.abs(got - ref).max() / scale < 5e-6, (n, "fft")
        assert np.abs(got - jout.to_numpy()).max() / scale < 5e-6, n
