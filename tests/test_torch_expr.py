"""Parity of the PyTorch port's expression engine with vexcl_tpu.

The same inputs, made from a numpy seed, go through both packages'
public APIs (``vex.eval``, assignment, compound assignment); results and
result dtypes must agree.  On CPU tensors the port runs each kernel's
plain PyTorch version; the kernels themselves are checked on the card by
tests/test_torch_cuda_*.py.

Tolerances are normwise, relative to the largest magnitude of the JAX
result: 1e-12 in f64, 1e-5 in f32 (XLA's CPU math and PyTorch's differ by
a few ulp in f32); integer and boolean results are exact.
"""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch import types as vtypes
from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.node import analyze, as_expr, infer_types
from vexcl_tpu_torch.expr.triton_emit import assign_source, kernel_key
from vexcl_tpu_torch.ops.triton_reduce import reduce_source
from chip_smoke import BUILTIN_DOMAIN, BUILTIN_INTEGER

N = 1000
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _pair(ctx1, tctx, arrays):
    return ([vex.vector(data=a, context=ctx1) for a in arrays],
            [vt.vector(data=a, context=tctx) for a in arrays])


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        return
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(1.0, np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rtol * scale)


def _eval_both(fn, jv, tv):
    return (np.asarray(vex.eval(fn(vex, *jv))),
            np.asarray(vt.eval(fn(vt, *tv))))


#: held against Python-integer oracles in tests/test_torch_builtins.py,
#: where the JAX package computes another thing than OpenCL on i64
_ORACLE = ("mad_hi", "mul_hi", "mad_sat", "rotate")


def _builtin_arrays(name, dt, rng):
    """Operands of one builtin: floats of dt over its domain, integers
    (i32 for f32, i64 for f64; i16 and i32 for ``upsample``) for the
    integer helpers, an i32 exponent for ``ldexp``."""
    nargs = vt.BUILTINS[name].nargs
    if name in BUILTIN_INTEGER:
        idt = np.int64 if dt == np.float64 else np.int32
        if name == "upsample":
            idt = np.int32 if dt == np.float64 else np.int16
        return [rng.integers(-1000, 1000, N).astype(idt)
                for _ in range(nargs)]
    lo, hi = BUILTIN_DOMAIN.get(name, (-3, 3))
    arrays = [(lo + (hi - lo) * rng.random(N)).astype(dt)
              for _ in range(nargs)]
    if name == "ldexp":
        arrays[1] = rng.integers(-20, 20, N).astype(np.int32)
    return arrays


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("name", [n for n in KERNEL_BUILTINS
                                  if n not in _ORACLE])
def test_builtin_parity(ctx1, tctx, name, dt):
    rng = np.random.default_rng(11)
    arrays = _builtin_arrays(name, dt, rng)
    jv, tv = _pair(ctx1, tctx, arrays)
    want, got = _eval_both(lambda m, *v: m.BUILTINS[name](*v), jv, tv)
    _close(got, want, RTOL[dt])


_EXPRS = {
    "saxpy": lambda m, a, b, c: 2 * a + b,
    "fused": lambda m, a, b, c: a + b * c,
    "sin_mix": lambda m, a, b, c: 2 * a + m.sin(b) - m.exp(c) / 3,
    "if_else": lambda m, a, b, c: m.if_else(a > b, a, b * 2),
    "cast": lambda m, a, b, c: m.cast(np.int32, a * 10) + b,
    "index_const": lambda m, a, b, c: (m.element_index() * 0.5
                                       + m.constants.pi() * a),
    "scalars": lambda m, a, b, c: a * 3 + 2.5 - np.float32(1.5) * b,
    "compare": lambda m, a, b, c: a > b,
    "temp": lambda m, a, b, c: (m.make_temp(1, a * b)
                                + 2 * m.make_temp(1, a * b)),
    "tag": lambda m, a, b, c: m.tag(1, a) * m.tag(1, a) + c,
    "float_floor_mod": lambda m, a, b, c: a // (b + 1.5) + a % (c - 2.5),
    "pow_neg": lambda m, a, b, c: -a ** 2 + abs(b),
}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_expression_parity(ctx1, tctx, name, dt):
    rng = np.random.default_rng(12)
    arrays = [(rng.standard_normal(N) * 3).astype(dt) for _ in range(3)]
    jv, tv = _pair(ctx1, tctx, arrays)
    want, got = _eval_both(_EXPRS[name], jv, tv)
    _close(got, want, RTOL[dt])


_INT_EXPRS = {
    "floordiv": lambda m, i, j: i // j,
    "mod": lambda m, i, j: i % j,
    "floordiv_scalar": lambda m, i, j: i // -3,
    "mod_scalar": lambda m, i, j: -i % 4,
    "truediv": lambda m, i, j: i / j,
    "times_float": lambda m, i, j: i * 2.5,
    "plus_int": lambda m, i, j: i + 1,
    "bits": lambda m, i, j: (i & j) ^ (i | 3),
    "shift": lambda m, i, j: (i << 2) >> 1,
}


@pytest.mark.parametrize("name", sorted(_INT_EXPRS))
def test_integer_expression_parity(ctx1, tctx, name):
    rng = np.random.default_rng(13)
    i = rng.integers(-50, 50, N).astype(np.int32)
    j = rng.choice([-7, -3, 2, 5], N).astype(np.int32)
    jv, tv = _pair(ctx1, tctx, [i, j])
    want, got = _eval_both(_INT_EXPRS[name], jv, tv)
    _close(got, want, 1e-12)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/=", "%="])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_compound_assignment_parity(ctx1, tctx, op, dt):
    rng = np.random.default_rng(14)
    arrays = [(rng.standard_normal(N) * 3 + 5).astype(dt) for _ in range(4)]
    (ja, jb, jc, jd), (ta, tb, tc, td) = _pair(ctx1, tctx, arrays)
    ja.assign(jb + jc * jd, op)
    ta.assign(tb + tc * td, op)
    _close(np.asarray(ta), np.asarray(ja), RTOL[dt])


@pytest.mark.parametrize("op", ["&=", "|=", "^=", "<<=", ">>=", "%=", "+="])
def test_integer_compound_assignment_parity(ctx1, tctx, op):
    rng = np.random.default_rng(15)
    a = rng.integers(-100, 100, N).astype(np.int32)
    b = rng.integers(1, 4, N).astype(np.int32)
    (ja, jb), (ta, tb) = _pair(ctx1, tctx, [a, b])
    ja.assign(jb, op)
    ta.assign(tb, op)
    _close(np.asarray(ta), np.asarray(ja), 0)


def test_vector_api(ctx1, tctx):
    rng = np.random.default_rng(16)
    a, b = rng.random(N), rng.random(N)
    (ja, jb), (ta, tb) = _pair(ctx1, tctx, [a, b])
    ja[:] = jb
    ta[:] = tb
    _close(np.asarray(ta), np.asarray(ja), 0)
    ja[:] = 3.5
    ta[:] = 3.5
    _close(np.asarray(ta), np.asarray(ja), 0)
    ta[5] = 1.25
    assert ta[5] == 1.25 and ta.size == N and len(ta) == N
    assert ta.dtype == torch.float64
    x = vt.vector(N, dtype="float", context=tctx)
    assert x.dtype == torch.float32 and np.all(np.asarray(x) == 0)
    x[:] = 2 * tb + 1
    np.testing.assert_allclose(np.asarray(x), (2 * b + 1).astype(np.float32))
    with pytest.raises(ValueError, match="size mismatch"):
        x[:] = vt.vector(N + 1, context=tctx) + 1


_CODES = ["b1", "u8", "u16", "u32", "i8", "i16", "i32", "i64", "bf16",
          "f16", "f32", "f64", "i*", "f*"]


def _jax_operand(code):
    import jax.numpy as jnp

    if code == "i*":
        return 1
    if code == "f*":
        return 1.0
    return jnp.dtype(str(vtypes.dtype_of_code(code)).replace("torch.", ""))


@pytest.mark.parametrize("a", _CODES)
def test_promotion_matches_jax(a):
    import jax.numpy as jnp

    for b in _CODES:
        want = jnp.result_type(_jax_operand(a), _jax_operand(b))
        got = vtypes.dtype_of_code(vtypes.join(a, b))
        assert str(got).replace("torch.", "") == str(want), (a, b)


def test_emitted_source_parses_and_caches_per_signature(tctx):
    rng = np.random.default_rng(17)
    v32 = [vt.vector(data=rng.random(N).astype(np.float32), context=tctx)
           for _ in range(3)]
    v64 = [vt.vector(data=rng.random(N), context=tctx) for _ in range(3)]
    vi = [vt.vector(data=rng.integers(-9, 9, N).astype(np.int32),
                    context=tctx) for _ in range(3)]
    srcs = set()
    for vs in (v32, v64):
        for name, fn in sorted(_EXPRS.items()):
            e, an, ty, _ = prepare(fn(vt, *vs), N, tctx.device)
            out = vtypes.code_of(vtypes.dtype_of_code(ty[id(e)]))
            src = assign_source(e, an, ty, out)
            ast.parse(src)
            srcs.add(src)
            if ty[id(e)] != "b1":
                for kind in ("SUM", "MIN", "MAX"):
                    ast.parse(reduce_source(e, an, ty, kind))
        for name in KERNEL_BUILTINS:
            args = (vi if name in BUILTIN_INTEGER else vs)[
                :vt.BUILTINS[name].nargs]
            if name == "ldexp":
                args = [vs[0], vi[0]]
            e, an, ty, _ = prepare(vt.BUILTINS[name](*args), N, tctx.device)
            ast.parse(assign_source(e, an, ty, ty[id(e)]))
    for fn in _INT_EXPRS.values():
        e, an, ty, _ = prepare(fn(vt, *vi[:2]), N, tctx.device)
        ast.parse(assign_source(e, an, ty, ty[id(e)]))
    assert len(srcs) >= len(_EXPRS)

    # one kernel per (signature, leaf types): new scalar values and new
    # vectors of the same types hit the same key; another dtype does not
    def key(vs, s):
        e = as_expr(s * vs[0] + vt.sin(vs[1]))
        return kernel_key(analyze(e), torch.float32)

    assert key(v32, 2.0) == key(v32[::-1], 7.5)
    assert key(v32, 2.0) != key(v64, 2.0)
    assert key(v32, 2.0) != key(v32, 2)
    cache = vt.ObjectCache("test")
    built = []
    for vs, s in ((v32, 2.0), (v32[::-1], 3.0), (v64, 2.0)):
        cache.get_or_create(key(vs, s), lambda: built.append(1) or object())
    assert len(built) == 2


def test_type_inference_matches_result_dtypes(tctx):
    x = vt.vector(N, dtype=np.int32, context=tctx)
    e = as_expr(x * 2.5)            # weak f64 stays f64 with an i32 ...
    assert vtypes.dtype_of_code(infer_types(e)[id(e)]) == torch.float64
    e = as_expr(x * 2.5 + vt.sin(x))  # ... and gives way to a strong f32
    assert vtypes.dtype_of_code(infer_types(e)[id(e)]) == torch.float32
    assert vt.eval(x / x).dtype == torch.float32
    assert vt.eval(x * 2).dtype == torch.int32


def test_uncovered_builtin_has_no_kernel_form():
    """No catalog entry lacks a kernel form: every builtin of a real type
    runs in the generated kernels on the card (the name is kept from when
    some had none)."""
    assert [n for n, b in vt.BUILTINS.items() if b.kernel_form is None] == []
    assert set(KERNEL_BUILTINS) == set(vt.BUILTINS)
    covered = {"sin", "cos", "exp", "log", "sqrt", "rsqrt", "fabs", "floor",
               "ceil", "fmin", "fmax", "pow", "sinpi", "select", "tgamma"}
    assert covered <= set(KERNEL_BUILTINS)


def test_port_imports_neither_jax_nor_vexcl_tpu():
    code = ("import sys, vexcl_tpu_torch, vexcl_tpu_torch.models; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'vexcl_tpu' or "
            "m.startswith('vexcl_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
