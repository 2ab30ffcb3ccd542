"""Complex vectors in expressions: the PyTorch port against vexcl_tpu on
the CPU.

The same seeded inputs go through ``vexcl_tpu`` (JAX on the CPU, x64 as
``conftest.py`` sets it) and ``vexcl_tpu_torch`` (the kernels' plain
forms).  Tolerances: relative to the magnitude of the JAX result plus
one, 1e-4 for trees with a 32-bit leaf (f32 parts; complex division and
products round in another order than XLA's) and 1e-10 for the rest; exact for
``real``, ``imag``, ``conj``, casts, views and comparisons of leaves.
Result types must agree.  On the CPU no Triton runs, so the generated
kernels are checked by their source: every tree of the fuzz emits a
source that parses, with (re, im) loads and stores, and what the kernel
does not cover raises ``NotImplementedError`` while the source is built.
"""

import ast

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
from vexcl_tpu_torch.expr.triton_emit import (assign_multi_source,
                                              assign_source, kernel_key,
                                              launch_args, params,
                                              tensor_arg)
from vexcl_tpu_torch.ops.triton_reduce import reduce_multi_source
from vexcl_tpu_torch.types import code_of, join, scalar_code

N = 203
SEEDS = (0, 1, 2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _jnp_code(dt) -> str:
    return code_of(torch.from_numpy(np.zeros(0, dtype=dt)).dtype)


PROMOTIONS = [
    ("f32", "c64"), ("f64", "c64"), ("f32", "c128"), ("c64", "c128"),
    ("i32", "c64"), ("b1", "c64"), ("f16", "c64"), ("bf16", "c64"),
    ("i64", "c64"), ("u8", "c128"),
]


@pytest.mark.parametrize("a,b", PROMOTIONS)
def test_join_matches_jnp(a, b):
    """The port's lattice join of two strong types is jnp's result type."""
    import jax.numpy as jnp

    names = {"f32": "float32", "f64": "float64", "c64": "complex64",
             "c128": "complex128", "i32": "int32", "b1": "bool",
             "f16": "float16", "bf16": "bfloat16", "i64": "int64",
             "u8": "uint8"}
    want = jnp.result_type(jnp.dtype(names[a]), jnp.dtype(names[b]))
    assert join(a, b) == _jnp_code(np.dtype(want.name)
                                   if want.name != "bfloat16" else want)


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.complex64,
                                np.int32, np.bool_])
def test_weak_complex_scalar_matches_jnp(tctx, ctx1, dt):
    """A weak Python complex with a vector of each type: jnp's type."""
    h = np.arange(5).astype(dt)
    jr = vex.eval(vex.vector(data=h, context=ctx1) * (1 + 2j))
    tr = vt.eval(vt.vector(data=h, context=tctx) * (1 + 2j))
    assert np.asarray(tr).dtype == np.asarray(jr).dtype
    np.testing.assert_allclose(np.asarray(tr), np.asarray(jr), rtol=1e-6)


# -- the seeded fuzz ---------------------------------------------------------

BINOPS = [
    lambda m, a, b: a + b,
    lambda m, a, b: a - b,
    lambda m, a, b: a * b,
    # a complex divisor of magnitude >= 1
    lambda m, a, b: a / (m.abs(b) + (1.0 + 0.5j)),
    lambda m, a, b: b / (a * m.conj(a) + 1.0),
]
UNOPS = [
    lambda m, e: m.conj(e),
    lambda m, e: m.real(e),
    lambda m, e: m.imag(e),
    lambda m, e: m.abs(e),
    lambda m, e: -e,
    lambda m, e: (0.5 - 1.5j) * e,
    lambda m, e: e * 2.0 + 1j,
]
LEAVES = ("c64", "c128", "f32", "weak_c", "weak_f", "np_c64")


def recipe(rng, depth):
    if depth == 0 or rng.random() < 0.25:
        return ("leaf", LEAVES[int(rng.integers(0, len(LEAVES)))],
                complex(rng.normal(), rng.normal()))
    if rng.random() < 0.45:
        return ("u", int(rng.integers(0, len(UNOPS))), recipe(rng, depth - 1))
    return ("b", int(rng.integers(0, len(BINOPS))), recipe(rng, depth - 1),
            recipe(rng, depth - 1))


def build(r, m, vecs):
    if r[0] == "leaf":
        kind, c = r[1], r[2]
        if kind in vecs:
            return vecs[kind]
        if kind == "weak_c":
            return c
        if kind == "weak_f":
            return c.real
        return np.complex64(c)
    if r[0] == "u":
        return UNOPS[r[1]](m, build(r[2], m, vecs))
    return BINOPS[r[1]](m, build(r[2], m, vecs), build(r[3], m, vecs))


def _sized(r) -> bool:
    if r[0] == "leaf":
        return r[1] in ("c64", "c128", "f32")
    return any(_sized(c) for c in r[2:])


def _on_vectors(r) -> bool:
    """Whether every operation of the tree has a vector beneath it, so
    that scalars enter only as leaves (an operation of numbers alone is
    computed by each framework on the host, outside the expression)."""
    if r[0] == "leaf":
        return True
    # the two divisions compute on each operand alone
    kids = r[2:]
    need = kids if r[0] == "b" and r[1] >= 3 else kids[:0]
    return (_sized(r) and all(_sized(c) for c in need)
            and all(_on_vectors(c) for c in kids))


def _arrays(rng):
    def c(dt):
        return (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(dt)
    return {"c64": c(np.complex64), "c128": c(np.complex128),
            "f32": rng.normal(size=N).astype(np.float32)}


def _narrow(r) -> bool:
    """Whether a 32-bit leaf (c64, f32) rounds anywhere in the tree."""
    if r[0] == "leaf":
        return r[1] in ("c64", "f32", "np_c64")
    return any(_narrow(c) for c in r[2:])


@pytest.mark.parametrize("seed", SEEDS)
def test_complex_expression_fuzz(seed, ctx1, tctx):
    """Random trees over c64, c128 and f32 vectors, weak complex and
    float scalars and numpy c64 scalars, through both packages: the
    result's type and values, and a generated kernel source that parses
    for each."""
    rng = np.random.default_rng(seed)
    arrs = _arrays(rng)
    jv = {k: vex.vector(data=a, context=ctx1) for k, a in arrs.items()}
    tv = {k: vt.vector(data=a, context=tctx) for k, a in arrs.items()}
    trees = 0
    while trees < 20:
        r = recipe(rng, int(rng.integers(1, 5)))
        if not _sized(r) or not _on_vectors(r):
            continue
        trees += 1
        jr = np.asarray(vex.eval(build(r, vex, jv)))
        te = build(r, vt, tv)
        tr = np.asarray(vt.eval(te))
        assert tr.dtype == jr.dtype, r
        code = code_of(torch.from_numpy(tr).dtype)
        tol = 1e-4 if _narrow(r) else 1e-10
        np.testing.assert_allclose(tr, jr, rtol=tol,
                                   atol=tol * (np.abs(jr).max() + 1),
                                   err_msg=str(r))
        e, an, ty, lv = prepare(te, N, CPU)
        src = assign_source(e, an, ty, code)
        ast.parse(src)
        if any(isinstance(l, torch.Tensor) and l.dtype.is_complex
               for l in lv):
            assert "tl.split(" in src, r
        if code.startswith("c"):
            assert "tl.join(" in src, r


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
def test_complex_sum_matches(dt, ctx1, tctx):
    """Reductor(SUM) of complex expressions, alone and beside a real MAX
    (K2's several accumulators), against the JAX package."""
    rng = np.random.default_rng(3)
    h = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(dt)
    g = rng.normal(size=N)
    ja, jg = vex.vector(data=h, context=ctx1), vex.vector(data=g,
                                                        context=ctx1)
    ta, tg = vt.vector(data=h, context=tctx), vt.vector(data=g, context=tctx)
    tol = 1e-5 if dt == np.complex64 else 1e-12
    for f in (lambda m, a, b: a, lambda m, a, b: a * m.conj(a) + b,
              lambda m, a, b: (2 - 1j) * a * b):
        js = vex.Reductor(vex.SUM)(f(vex, ja, jg))
        ts = vt.Reductor(vt.SUM, context=tctx)(f(vt, ta, tg))
        assert isinstance(ts, complex)
        assert abs(ts - js) <= tol * (abs(js) + N)
    bodies, an, ty, lv = prepare_multi([ta * ta, tg], N, CPU)
    src = reduce_multi_source([(bodies[0], "SUM"), (bodies[1], "MAX")], an,
                              ty)
    ast.parse(src)
    assert "tl.split(" in src


def test_complex_views_and_tie(ctx1, tctx):
    """A complex vector read through a permutation (an index out of range
    reads NaN + 0j, as ``jnp.take``), a slice and a raw pointer, and a
    ``tie`` of complex vectors (the swap)."""
    rng = np.random.default_rng(5)
    h = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    idx = rng.integers(-N, N + 7, N).astype(np.int32)
    ja, ta = vex.vector(data=h, context=ctx1), vt.vector(data=h,
                                                         context=tctx)
    ji, ti = vex.vector(data=idx, context=ctx1), vt.vector(data=idx,
                                                           context=tctx)
    jr = np.asarray(vex.eval(vex.permutation(ji)(ja) * 2))
    tr = np.asarray(vt.eval(vt.permutation(ti)(ta) * 2))
    np.testing.assert_array_equal(tr, jr)
    tr = np.asarray(vt.eval(vt.permutation(ti)(ta)))
    np.testing.assert_array_equal(tr, np.asarray(vex.eval(
        vex.permutation(ji)(ja))))
    assert np.isnan(tr.real).any() and (tr[np.isnan(tr.real)].imag == 0).all()
    jp = np.asarray(vex.eval(vex.raw_pointer(ja)[(vex.element_index(0, N)
                                                  * 3) % N]))
    tp = np.asarray(vt.eval(vt.raw_pointer(ta)[(vt.element_index(0, N)
                                                * 3) % N]))
    np.testing.assert_array_equal(tp, jp)
    ts = vt.vector(N - 1, dtype=np.complex64, context=tctx)
    ts[:] = ta[1:] - vt.conj(ta[:N - 1])
    np.testing.assert_allclose(ts.to_numpy(), h[1:] - np.conj(h[:-1]),
                               rtol=1e-6)
    tb = vt.vector(data=h[::-1].copy(), context=tctx)
    vt.tie(ta, tb)[:] = (tb, ta)
    np.testing.assert_array_equal(ta.to_numpy(), h[::-1])
    np.testing.assert_array_equal(tb.to_numpy(), h)
    exprs, an, ty, lv = prepare_multi([tb * 1j, ta + tb], N, CPU)
    src = assign_multi_source(exprs, an, ty, ["c64", "c64"])
    ast.parse(src)
    assert src.count("tl.join(") == 2


@pytest.mark.parametrize("src_dt,dst_dt", [
    (np.float32, np.complex64), (np.complex64, np.float32),
    (np.complex128, np.complex64), (np.complex64, np.bool_),
    (np.complex128, np.int32), (np.float64, np.complex128)])
def test_casts_match(src_dt, dst_dt, ctx1, tctx):
    """Casts between real and complex types: a complex value's real part,
    whether either part is not 0, a real value with 0 imaginary part."""
    rng = np.random.default_rng(7)
    h = (rng.normal(size=N) * 3).astype(src_dt)
    if np.iscomplexobj(h):
        h = (h + 1j * rng.normal(size=N) * 3).astype(src_dt)
        h[:4] = [0, 1j, 2, 0]
    jr = np.asarray(vex.eval(vex.cast(dst_dt, vex.vector(data=h,
                                                        context=ctx1))))
    tr = np.asarray(vt.eval(vt.cast(dst_dt, vt.vector(data=h,
                                                     context=tctx))))
    assert tr.dtype == jr.dtype
    np.testing.assert_array_equal(tr, jr)


def test_kernel_keys_and_arguments(tctx):
    """A c64 leaf and an f32 leaf never share a kernel key; a complex
    leaf crosses as a pointer to its real type, a complex scalar as two
    arguments (f64 bits for weak and c128 values, f32 for c64)."""
    a = vt.vector(N, dtype=np.complex64, context=tctx)
    b = vt.vector(N, dtype=np.float32, context=tctx)
    keys = []
    for v in (a, b):
        e, an, ty, lv = prepare(v * 2.0, N, CPU)
        keys.append(kernel_key(an, (torch.complex64,)))
    assert keys[0] != keys[1]
    arg = tensor_arg(a.storage)
    assert arg.dtype == torch.float32
    assert arg.data_ptr() == a.storage.data_ptr()
    assert tensor_arg(torch.zeros((), dtype=torch.complex128)).dtype \
        == torch.float64
    e, an, ty, lv = prepare(a * (1 + 2j) + np.complex64(3 - 1j), N, CPU)
    args = launch_args(lv)
    assert len(args) == len(params(an))
    assert [scalar_code(s) for s in lv if not isinstance(s, torch.Tensor)] \
        == ["c*", "c64"]
    assert args[-2:] == [3.0, -1.0]
    assert args[1] == np.float64(1.0).view(np.int64)


def test_uncovered_raise_at_build(tctx):
    """What the kernel does not cover raises while its source is built:
    a transcendental of a complex value, an order, MIN of complex values,
    a complex value through V3."""
    from vexcl_tpu_torch.expr.compile import prepare_view_assign
    from vexcl_tpu_torch.expr.triton_emit import assign_to_view_source

    a = vt.vector(N, dtype=np.complex64, context=tctx)
    for expr in (vt.sin(a), vt.exp(a) + 1, a < a, a ** 2, vt.sqrt(a)):
        e, an, ty, lv = prepare(expr, N, CPU)
        with pytest.raises(NotImplementedError):
            assign_source(e, an, ty, ty[id(e)])
    e, an, ty, lv = prepare(a, N, CPU)
    with pytest.raises(NotImplementedError):
        reduce_multi_source([(e, "MIN")], an, ty)
    with pytest.raises(NotImplementedError):
        reduce_multi_source([(e, "SUM_Kahan")], an, ty)
    idx = vt.vector(data=np.arange(N, dtype=np.int32)[::-1].copy(),
                    context=tctx)
    val, view, an, ty, lv, out, mode, n = prepare_view_assign(
        vt.permutation(idx)(a), a * 2)
    with pytest.raises(NotImplementedError):
        assign_to_view_source(val, view, an, ty, code_of(out.dtype), mode)
