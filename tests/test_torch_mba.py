"""MBA: the PyTorch port against vexcl_tpu on the CPU.

The cases of ``tests/test_generator_mba_profiler.py``: 1-D and 2-D fits,
an interpolant in an expression, exact refinement, the patch form against
the lattice form, two domains of one structure, and ``levels=0``.  The
same numpy-seeded samples and queries go through ``vexcl_tpu`` (JAX on
the CPU, x64) and ``vexcl_tpu_torch`` (the assignment kernel's plain
form).  Tolerances: the host fit is the same numpy code, so lattices are
equal bit for bit; evaluations in f64 agree within 1e-12 (another
summation order of the 4^d taps); the oracles of the JAX tests (the
fitted function) keep their tolerances; f32 queries against the f64 host
evaluation 1e-5.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.ops import mba as tmba


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _eval(interp, ctx, qs, dtype=np.float64, patch=False):
    """``interp`` at the points ``qs``; with ``patch``, its patch form
    through ``mba_device_eval``."""
    vs = [vt.vector(data=q.astype(dtype), context=ctx) for q in qs]
    z = vt.vector(len(qs[0]), dtype=dtype, context=ctx)
    if patch:
        tab = interp.tables(torch.from_numpy(np.zeros(0, dtype)).dtype,
                            ctx.device)[1]
        z[:] = tmba.mba_device_eval(interp.lo, interp.hi, interp.grids,
                                    None, vs, patch=tab)
    else:
        z[:] = interp(*vs)
    return z.to_numpy()


def test_mba_1d(ctx1, tctx, rng):
    pts = rng.random(400)
    vals = np.sin(2 * np.pi * pts)
    ja = vex.mba([-0.01], [1.01], [pts], vals, grid=[8], levels=8)
    ta = vt.mba([-0.01], [1.01], [pts], vals, grid=[8], levels=8)
    np.testing.assert_array_equal(ta.lattice, np.asarray(
        ja._lattices_dev[0]))
    hq = np.linspace(0.05, 0.95, 200)
    z = vex.vector(200, dtype=np.float64, context=ctx1)
    z[:] = ja(vex.vector(data=hq, context=ctx1))
    tz = _eval(ta, tctx, [hq])
    np.testing.assert_allclose(tz, np.sin(2 * np.pi * hq), atol=5e-3)
    np.testing.assert_allclose(tz, np.asarray(z), rtol=0, atol=1e-12)


def test_mba_2d(ctx1, tctx, rng):
    """2-D fit (tests/mba.cpp pattern): f(x,y) = x*y, alone and in an
    expression."""
    n = 4000
    px, py = rng.random(n), rng.random(n)
    vals = px * py
    ja = vex.mba([-0.01, -0.01], [1.01, 1.01], [px, py], vals, grid=[4, 4],
                 levels=9)
    ta = vt.mba([-0.01, -0.01], [1.01, 1.01], [px, py], vals, grid=[4, 4],
                levels=9)
    assert ta.grids == ja.grids
    m = 300
    qx, qy = rng.random(m), rng.random(m)
    X, Y = (vex.vector(data=q, context=ctx1) for q in (qx, qy))
    TX, TY = (vt.vector(data=q, context=tctx) for q in (qx, qy))
    z = vex.vector(m, dtype=np.float64, context=ctx1)
    tz = vt.vector(m, dtype=np.float64, context=tctx)
    z[:] = ja(X, Y)
    tz[:] = ta(TX, TY)
    np.testing.assert_allclose(tz.to_numpy(), qx * qy, atol=2e-2)
    np.testing.assert_allclose(tz.to_numpy(), np.asarray(z), rtol=0,
                               atol=1e-12)
    z[:] = 1.0 + ja(X, Y)
    tz[:] = 1.0 + ta(TX, TY)
    np.testing.assert_allclose(tz.to_numpy(), 1 + qx * qy, atol=2e-2)
    np.testing.assert_allclose(tz.to_numpy(), np.asarray(z), rtol=0,
                               atol=1e-12)


def test_mba_refinement_exact(rng):
    """The flattening refinement is exact: a lattice refined onto the
    doubled grid evaluates identically (the port's copy of the host
    code, held against the JAX package's)."""
    from vexcl_tpu.ops.mba import _refine_np as jrefine

    lo, hi = (-0.01, -0.01), (1.01, 1.01)
    g = (8, 6)
    lat = rng.standard_normal((g[0] + 3, g[1] + 3))
    pts = (rng.random(2000), rng.random(2000))
    a = tmba._eval_level_host(lo, hi, g, lat, pts)
    b = tmba._eval_level_host(lo, hi, tuple(2 * x for x in g),
                              tmba._refine_np(lat, g), pts)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tmba._refine_np(lat, g), jrefine(lat, g))


def test_mba_patch_path_matches_lattice(tctx, rng):
    """The patch-row form and the lattice form agree in 1/2/3-D, and with
    the JAX package's (another summation order: 1e-12)."""
    import jax.numpy as jnp

    from vexcl_tpu.ops.mba import mba_device_eval as jeval

    for d, grid in ((1, (8,)), (2, (8, 6)), (3, (4, 4, 4))):
        sc = [rng.random(1500) for _ in range(d)]
        sv = sum(np.sin(3 * c) for c in sc)
        kw = dict(lo=(-0.01,) * d, hi=(1.01,) * d, coords=sc, values=sv,
                  grid=grid, levels=3)
        js, ts = vex.mba(**kw), vt.mba(**kw)
        assert ts.patch is not None
        np.testing.assert_array_equal(ts.patch, np.asarray(js._patch_dev))
        q = [rng.random(4000) for _ in range(d)]
        want = np.asarray(jeval(js.lo, js.hi, js.grids, None,
                                [jnp.asarray(c) for c in q],
                                patch=js._patch_dev))
        qt = [vt.vector(data=c, context=tctx) for c in q]
        a = vt.eval(tmba.mba_device_eval(ts.lo, ts.hi, ts.grids,
                                         [torch.from_numpy(ts.lattice)], qt))
        b = vt.eval(tmba.mba_device_eval(ts.lo, ts.hi, ts.grids, None, qt,
                                         patch=torch.from_numpy(ts.patch)))
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-12)


def test_mba_distinct_domains_not_shared(tctx, rng):
    """Two interpolants of one structure over different domains: the
    domain crosses as scalar leaves, so they share one kernel signature
    and each gives its own values."""
    from vexcl_tpu_torch.expr.node import analyze

    pts = rng.random(2000)
    a = vt.mba([-0.01], [1.01], [pts], np.sin(pts), grid=[8], levels=6)
    pts10 = pts * 10
    b = vt.mba([-0.1], [10.1], [pts10], np.sin(pts10 / 10), grid=[8],
               levels=6)
    q = rng.random(200)
    Q = vt.vector(data=q, context=tctx)
    Q10 = vt.vector(data=q * 10, context=tctx)
    assert analyze(a(Q)).sig == analyze(b(Q10)).sig
    np.testing.assert_allclose(_eval(a, tctx, [q]), np.sin(q), atol=5e-3)
    np.testing.assert_allclose(_eval(b, tctx, [q * 10]), np.sin(q),
                               atol=5e-3)


def test_mba_levels_zero_raises():
    with pytest.raises(ValueError, match="levels"):
        vt.mba([0.0], [1.0], [np.array([0.5])], np.array([1.0]), grid=[4],
               levels=0)


def test_mba_f32_queries_and_edges(tctx):
    """The bench's fit (4096 samples of sin(7x) cos(5y), grid 8x8, 6
    levels: a 259^2 lattice) at f32 queries, corners and the domain's
    edges included, in both forms: within 1e-5 of the f64 host
    evaluation, never NaN (no tap leaves its table: the explicit clamp
    of i0 where ``grid - 1e-12`` rounds to ``grid`` in f32)."""
    rng = np.random.default_rng(7)
    sx, sy = rng.random(4096), rng.random(4096)
    ip = vt.mba((-0.01, -0.01), (1.01, 1.01), (sx, sy),
                np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8), levels=6)
    assert ip.lattice.shape == (259, 259) and ip.patch is not None
    q = [rng.random(4096).astype(np.float32) for _ in range(2)]
    for c in q:
        c[:6] = [-0.01, 1.01, 0.0, 1.0, 1.0099999, -0.5]
    want = tmba._eval_level_host(ip.lo, ip.hi, ip.grids[0], ip.lattice,
                                 [c.astype(np.float64) for c in q])
    for form in (False, True):
        got = _eval(ip, tctx, q, np.float32, patch=form)
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mba_tables_once_per_type_and_device(tctx, rng):
    pts = rng.random(300)
    ip = vt.mba([0.0], [1.0], [pts], pts * pts, grid=[4], levels=2)
    X = vt.vector(data=pts.astype(np.float32), context=tctx)
    ip(X)
    ip(X * 2)
    assert list(ip._tables) == [(torch.float32, torch.device("cpu"))]
    ip(vt.vector(data=pts, context=tctx))
    assert len(ip._tables) == 2


_NODE_GRID = {1: [8], 2: [6, 5], 3: [4, 3, 4], 4: [2, 2, 2, 2]}


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_mba_node_matches_jax(ctx1, tctx, rng, d, dt):
    """``z[:] = interp(*coords)``: one ``MBAExpr`` node for 1-3 axes (the
    CUDA kernel's, its plain version here), the tree for 4 (a route by
    structure), against the JAX package's interpolant: f64 within 1e-12,
    f32 queries (the port keeps f32 tables, the JAX package f64 ones)
    within 1e-5."""
    from vexcl_tpu_torch.ops.mba import MBAExpr

    sc = [rng.random(600) for _ in range(d)]
    kw = dict(lo=[-0.01] * d, hi=[1.01] * d, coords=sc,
              values=sum(np.sin(2 * c) for c in sc), grid=_NODE_GRID[d],
              levels=2)
    ja, ta = vex.mba(**kw), vt.mba(**kw)
    m = 257
    q = [rng.random(m).astype(dt) for _ in range(d)]
    q[0][:3] = [-0.5, 1.01, 1.5]
    jq = [vex.vector(data=c.astype(np.float64), context=ctx1) for c in q]
    z = vex.vector(m, dtype=np.float64, context=ctx1)
    z[:] = ja(*jq)
    tq = [vt.vector(data=c, context=tctx) for c in q]
    expr = ta(*tq)
    assert isinstance(expr, MBAExpr) == (d <= 3)
    tz = vt.vector(m, dtype=dt, context=tctx)
    tz[:] = expr
    np.testing.assert_allclose(tz.to_numpy(), np.asarray(z), rtol=0,
                               atol=1e-12 if dt == np.float64 else 1e-5)


def test_mba_in_a_larger_tree_matches_jax(ctx1, tctx, rng):
    """``2 * interp(X, Y) + W`` and an interpolant at expressions of the
    vectors (evaluated into the kernel's coordinates first)."""
    px, py = rng.random(900), rng.random(900)
    kw = dict(lo=[-0.01, -0.01], hi=[1.01, 1.01], coords=[px, py],
              values=np.cos(3 * px) + py, grid=[5, 5], levels=3)
    ja, ta = vex.mba(**kw), vt.mba(**kw)
    m = 300
    qx, qy, w = rng.random(m), rng.random(m), rng.random(m)
    X, Y, W = (vex.vector(data=a, context=ctx1) for a in (qx, qy, w))
    TX, TY, TW = (vt.vector(data=a, context=tctx) for a in (qx, qy, w))
    for jexpr, texpr in ((2 * ja(X, Y) + W, 2 * ta(TX, TY) + TW),
                         (ja(X * 0.5, 1.0 - Y), ta(TX * 0.5, 1.0 - TY))):
        z = vex.vector(m, dtype=np.float64, context=ctx1)
        tz = vt.vector(m, dtype=np.float64, context=tctx)
        z[:] = jexpr
        tz[:] = texpr
        np.testing.assert_allclose(tz.to_numpy(), np.asarray(z), rtol=0,
                                   atol=1e-12)


def test_mba_interpolants_of_one_structure_share_a_kernel(tctx, rng):
    """Two interpolants of one structure (other domains, data and grids'
    lattices) have one signature, alone and inside a tree, so they share
    the kernels compiled for it; each gives its own values."""
    from vexcl_tpu_torch.expr.node import analyze

    pts = rng.random(500)
    a = vt.mba([0.0], [1.0], [pts], np.sin(pts), grid=[8], levels=3)
    b = vt.mba([-2.0], [3.0], [pts * 5 - 2], pts ** 2, grid=[8], levels=2)
    Q = vt.vector(data=rng.random(64), context=tctx)
    assert analyze(a(Q)).sig == analyze(b(Q)).sig
    assert analyze(2 * a(Q) + 1).sig == analyze(2 * b(Q) + 1).sig
    za, zb = (vt.vector(64, dtype=np.float64, context=tctx)
              for _ in range(2))
    za[:] = a(Q)
    zb[:] = b(Q)
    assert not np.allclose(za.to_numpy(), zb.to_numpy())


@pytest.mark.parametrize("d", [1, 2, 3])
def test_mba_kernel_table_by_type(tctx, rng, d):
    """The CUDA kernel's table, made once per type and device: f32 the
    flattened lattice itself, f64 four entries a control whose entry j
    holds controls j .. j + 3 of the flattened lattice (clipped at its
    end)."""
    from vexcl_tpu_torch.ops import cuda_mba

    sc = [rng.random(200) for _ in range(d)]
    ip = vt.mba([0.0] * d, [1.0] * d, sc, sum(sc), grid=[3] * d, levels=2)
    flat = ip.lattice.reshape(-1)
    t32 = ip.kernel_table(torch.float32, torch.device("cpu"))
    assert ip.kernel_table(torch.float32, torch.device("cpu")) is t32
    np.testing.assert_array_equal(t32.numpy(), flat.astype(np.float32))
    t64 = cuda_mba.table(torch.from_numpy(ip.lattice))
    at = np.minimum(np.arange(flat.size)[:, None] + np.arange(4),
                    flat.size - 1)
    np.testing.assert_array_equal(t64.numpy(), flat[at].reshape(-1))
