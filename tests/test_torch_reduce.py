"""Parity of the port's map-reduce and Reductor with vexcl_tpu.

The port's plain map-reduce (the CPU form of ops/triton_reduce.py) is
held against ``vexcl_tpu.ops.pallas_reduce.pallas_map_reduce`` run in
interpret mode, as the JAX package's own tests run it on CPU, at a
ragged size so the tail mask matters.  The Reductor is compared through
both public APIs, with one kind and with several (``MIN_MAX``,
``CombineReductors``), ``SUM_Kahan`` and over a multivector.

Tolerances: f32 sums 1e-5 relative (the two kernels add in another
order), f64 sums 1e-12, MIN and MAX and integer sums exact.  Kahan: both
packages take chunk sums of 4096 values and a compensated sum of the
chunks; the chunk sums may round differently (another summation order
in a chunk), so the test takes chunks that sum exactly, and then the
f32 results agree within 1 ulp of each other and of the exact sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.ops.pallas_reduce import pallas_map_reduce
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.ops.triton_reduce import map_reduce_plain

N_PALLAS = (1 << 19) + 1000
N = 10007


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _sum_close(got, want, rtol):
    assert abs(got - want) <= rtol * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("kind,which", [("SUM", "mul"), ("MIN", "mul"),
                                        ("MAX", "mul"), ("SUM", "exp")])
def test_plain_map_reduce_matches_pallas_interpret(tctx, kind, which):
    rng = np.random.default_rng(21)
    x = rng.random(N_PALLAS).astype(np.float32)
    y = (rng.random(N_PALLAS) - 0.5).astype(np.float32)
    if which == "mul":
        want = float(pallas_map_reduce([jnp.asarray(x), jnp.asarray(y)], [],
                                       lambda b, s: b[0] * b[1], kind))
    else:
        want = float(pallas_map_reduce([jnp.asarray(x)], [],
                                       lambda b, s: jnp.exp(b[0]), kind))
    tx = vt.vector(data=x, context=tctx)
    ty = vt.vector(data=y, context=tctx)
    expr = tx * ty if which == "mul" else vt.exp(tx)
    e, an, ty_, lv = prepare(expr, N_PALLAS, tctx.device)
    got = map_reduce_plain(e, an, ty_, lv, N_PALLAS, kind,
                           tctx.device).item()
    if kind == "SUM":
        _sum_close(got, want, 1e-5)
    else:
        assert got == want


_EXPRS = {
    "mul": lambda m, x, y: x * y,
    "exp": lambda m, x, y: m.exp(x),
    "mix": lambda m, x, y: m.sin(x) + 2 * y,
    "where": lambda m, x, y: m.if_else(x > 0.5, x, -y),
}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["SUM", "MIN", "MAX"])
@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_reductor_parity(ctx1, tctx, name, kind, dt):
    rng = np.random.default_rng(22)
    x = rng.random(N).astype(dt)
    y = (rng.random(N) - 0.5).astype(dt)
    jx, jy = (vex.vector(data=a, context=ctx1) for a in (x, y))
    tx, ty = (vt.vector(data=a, context=tctx) for a in (x, y))
    want = vex.Reductor(getattr(vex, kind))(_EXPRS[name](vex, jx, jy))
    got = vt.Reductor(getattr(vt, kind))(_EXPRS[name](vt, tx, ty))
    if kind == "SUM":
        _sum_close(got, want, 1e-12 if dt == np.float64 else 1e-5)
    else:
        assert got == want


def test_reductor_kinds_and_dtypes(ctx1, tctx):
    rng = np.random.default_rng(23)
    x = rng.random(N).astype(np.float32)
    i = rng.integers(-1000, 1000, N).astype(np.int32)
    jx, ji = (vex.vector(data=a, context=ctx1) for a in (x, i))
    tx, ti = (vt.vector(data=a, context=tctx) for a in (x, i))
    assert vt.Reductor(vt.MIN_MAX)(tx) == vex.Reductor(vex.MIN_MAX)(jx)
    _sum_close(vt.Reductor(vt.SUM_Kahan)(tx * 3),
               vex.Reductor(vex.SUM_Kahan)(jx * 3), 1e-6)
    _sum_close(vt.Reductor(np.float64, vt.SUM)(tx),
               vex.Reductor(np.float64, vex.SUM)(jx), 1e-12)
    got, want = vt.Reductor(vt.SUM)(ti * 3), vex.Reductor(vex.SUM)(ji * 3)
    assert got == want and isinstance(got, int)
    assert vt.Reductor(vt.MAX)(ti) == vex.Reductor(vex.MAX)(ji)
    # a sized element index reduces without any vector
    n = 1 << 12
    assert (vt.Reductor(vt.SUM, context=tctx)(vt.element_index(0, n))
            == vex.Reductor(vex.SUM)(vex.element_index(0, n)))
    with pytest.raises(vt.ExpressionError):
        vt.Reductor(vt.SUM)(vt.constant(1.0) * 2)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["MIN", "MAX"])
@pytest.mark.parametrize("pos", [0, 4096 + 5, 3 * 4096 + 70])
def test_min_max_propagate_nan(ctx1, tctx, kind, dt, pos):
    """A NaN anywhere, at a size that is not a multiple of REDUCE_BLOCK,
    makes MIN and MAX NaN in both packages (jnp.min/jnp.max)."""
    from vexcl_tpu_torch.ops.triton_reduce import REDUCE_BLOCK

    n = 3 * REDUCE_BLOCK + 77
    x = (np.random.default_rng(24).random(n) - 0.5).astype(dt)
    x[pos] = np.nan
    jx = vex.vector(data=x, context=ctx1)
    tx = vt.vector(data=x, context=tctx)
    want = vex.Reductor(getattr(vex, kind))(jx * 2)
    got = vt.Reductor(getattr(vt, kind))(tx * 2)
    assert np.isnan(want) and np.isnan(got)


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("kinds", ["MIN_MAX", "SUM_MIN_MAX", "MAX_SUM_SUM"])
def test_combined_kinds(ctx1, tctx, kinds, dt):
    rng = np.random.default_rng(25)
    x = (rng.random(N) * 100 - 30).astype(dt)
    jx = vex.vector(data=x, context=ctx1)
    tx = vt.vector(data=x, context=tctx)

    def combined(m):
        if kinds == "MIN_MAX":
            return m.MIN_MAX
        return m.CombineReductors(*[getattr(m, k) for k in kinds.split("_")])

    want = vex.Reductor(combined(vex))(jx * 2 - 1)
    got = vt.Reductor(combined(vt))(tx * 2 - 1)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w, k in zip(got, want, kinds.split("_")):
        if k == "SUM" and dt != np.int32:
            _sum_close(g, w, 1e-12 if dt == np.float64 else 1e-5)
        else:
            assert g == w


def test_kahan_sum_against_jax(ctx1, tctx):
    """1.0 followed by 2^20 - 1 values of 2^-40: every chunk of 4096
    values sums exactly in any order (2^-28 apart from the first), and
    each chunk sum is below half an ulp of 1.0, so only the compensated
    sum of the chunks keeps them."""
    x = np.full(1 << 20, 2.0 ** -40, np.float32)
    x[0] = 1.0
    jx = vex.vector(data=x, context=ctx1)
    tx = vt.vector(data=x, context=tctx)
    want = vex.Reductor(vex.SUM_Kahan)(jx)
    got = vt.Reductor(vt.SUM_Kahan)(tx)
    exact = float(x.astype(np.float64).sum())
    ulp = float(np.spacing(np.float32(exact)))
    assert abs(got - want) <= ulp and abs(got - exact) <= ulp
    assert got != 1.0
    i = np.arange(1000, dtype=np.int32)    # Kahan of integers: their sum
    assert vt.Reductor(vt.SUM_Kahan)(vt.vector(data=i, context=tctx)) == \
        int(i.sum())


@pytest.mark.parametrize("kind", ["SUM", "MAX", "MIN_MAX"])
def test_reductor_over_multivector(ctx1, tctx, kind):
    """One result per component (one launch of the kernel on the card)."""
    rng = np.random.default_rng(26)
    h = rng.random((3, N))
    jm = vex.multivector(data=h, context=ctx1)
    tm = vt.multivector(data=h, context=tctx)
    want = vex.Reductor(getattr(vex, kind))(jm * 2)
    got = vt.Reductor(getattr(vt, kind))(tm * 2)
    assert len(got) == 3
    for g, w in zip(got, want):
        if kind == "SUM":
            _sum_close(g, w, 1e-12)
        else:
            assert g == w
    if kind != "SUM":           # the multivector itself
        assert vt.Reductor(getattr(vt, kind))(tm) == vex.Reductor(
            getattr(vex, kind))(jm)
