"""Parity of the port's views with vexcl_tpu: slicer, permutation,
reshape, reduce_view, raw pointers, multi_array, tensordot, assignment
through views, atomic updates, gather/scatter and any_of/all_of.

The same numpy inputs (from a seed) go through both packages on the CPU,
where the port's view kernels run their plain versions (the nodes'
``emit``, ``assign_to_view_plain``, ``reduce_view_plain``).  Every case of
``tests/test_views.py``, ``tests/test_multi_array.py`` and
``tests/test_pointer_util.py`` is here, with nested views, views inside
``tie`` and a Reductor, the out-of-range rules (a gather through a key
wraps negatives and clamps, a permutation reads NaN or the least
integer, a scatter drops), the aliasing cases (a target read through a
view), ``reduce_view``'s result types, and seeded smoke versions of
``exp/fuzz_views.py`` and ``exp/fuzz_donate.py`` (with view targets)
against both packages and a numpy mirror.

Tolerances, relative to the largest magnitude: gathers, stores, moves,
min, max and integer results exact; sums 1e-12 (f64) and 1e-5 (f32,
another summation order); tensordot 1e-10 (f64).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt

N = 32
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(1.0, np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=rtol * scale)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _pair(h, ctx1, tctx):
    return (vex.vector(data=h, context=ctx1), vt.vector(data=h, context=tctx))


def _out(n, dt, ctx1, tctx):
    return (vex.vector(n, dtype=dt, context=ctx1),
            vt.vector(n, dtype=dt, context=tctx))


# -- tests/test_views.py, through both packages ----------------------------

@pytest.mark.parametrize("key", [5, (slice(None), 7), (vex.r(0, 2, 16),),
                                 (slice(3, None, 5), slice(None, None, -3)),
                                 (slice(None, None, -1), 4), (3, 5)])
def test_slicer_keys(ctx1, tctx, key):
    """Rows, columns, strided ranges, negative steps, two ints (a view of
    one element that broadcasts)."""
    hx = np.random.default_rng(1).random(N * N)
    jx, tx = _pair(hx, ctx1, tctx)
    tkey = tuple(vt.r(k.slice.start, k.slice.step, k.slice.stop)
                 if isinstance(k, vex.r) else k for k in
                 (key if isinstance(key, tuple) else (key,)))
    want = np.ravel(hx.reshape(N, N)[tuple(k.slice if isinstance(k, vt.r)
                                           else k for k in tkey)])
    n = max(want.size, 1) if want.size != 1 else 3
    jy, ty = _out(n, np.float64, ctx1, tctx)
    jy[:] = vex.slicer((N, N))[key](jx) * 2 + 1
    ty[:] = vt.slicer((N, N))[tkey](tx) * 2 + 1
    _exact(ty.to_numpy(), jy.to_numpy())
    _exact(ty.to_numpy(), np.broadcast_to(want * 2 + 1, (n,)))


def test_1d_slice_of_vector(ctx1, tctx):
    hx = np.random.default_rng(2).random(N * N)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(100, np.float64, ctx1, tctx)
    jy[:] = jx[200:300]
    ty[:] = tx[200:300]
    _exact(ty.to_numpy(), jy.to_numpy())


@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_permutation(ctx1, tctx, idt):
    rng = np.random.default_rng(3)
    hx = rng.random(N * N)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(N * N, np.float64, ctx1, tctx)
    jy[:] = vex.permutation(N * N - 1 - vex.element_index(0, N * N))(jx)
    ty[:] = vt.permutation(N * N - 1 - vt.element_index(0, N * N))(tx)
    _exact(ty.to_numpy(), hx[::-1])
    _exact(ty.to_numpy(), jy.to_numpy())
    hp = rng.permutation(N * N).astype(idt)
    jp, tp = _pair(hp, ctx1, tctx)
    jy[:] = vex.permutation(jp)(jx)
    ty[:] = vt.permutation(tp)(tx)
    _exact(ty.to_numpy(), jy.to_numpy())


@pytest.mark.parametrize("dst,order", [((17, 12), (1, 0)), ((8, 6), (1,)),
                                       ((4, 5, 6), (2, 0, 1)),
                                       ((3, 4, 5), (0, 2))])
def test_reshape(ctx1, tctx, dst, order):
    """Transposes and broadcasts (order a subset of the dims)."""
    n = int(np.prod([dst[o] for o in order]))
    hx = np.random.default_rng(4).random(n)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(int(np.prod(dst)), np.float64, ctx1, tctx)
    jy[:] = vex.reshape(jx, dst, order=order)
    ty[:] = vt.reshape(tx, dst, order=order)
    _exact(ty.to_numpy(), jy.to_numpy())


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("axis", [0, 1, (0, 1), -1])
def test_slice_reduce(ctx1, tctx, op, axis):
    hx = np.random.default_rng(5).random(N * N) + 0.5
    jx, tx = _pair(hx, ctx1, tctx)
    want = vex.eval(vex.reduce_view(op, vex.slicer((N, N))[:, :](jx), axis))
    got = vt.eval(vt.reduce_view(op, vt.slicer((N, N))[:, :](tx), axis))
    _close(got, np.ravel(want), RTOL[np.float64])
    # inside an expression, into a vector
    n = np.ravel(want).size
    jy, ty = _out(n, np.float64, ctx1, tctx)
    jy[:] = 2 * vex.reduce_view(op, vex.slicer((N, N))[:, :](jx), axis) + 1
    ty[:] = 2 * vt.reduce_view(op, vt.slicer((N, N))[:, :](tx), axis) + 1
    _close(ty.to_numpy(), jy.to_numpy(), RTOL[np.float64])


@pytest.mark.parametrize("dst,order", [((1000, 777), (1, 0)),
                                       ((37, 45, 29), (2, 0, 1)),
                                       ((37, 45, 29), (0, 2, 1)),
                                       ((100, 77), (0,))])
def test_reshape_tiled_shapes(ctx1, tctx, dst, order):
    """The tiled kernel's card shapes (no tile multiples), alone and beside
    a leaf read in the output's order."""
    n = int(np.prod([dst[o] for o in order]))
    m = int(np.prod(dst))
    rng = np.random.default_rng(6)
    hx, hz = rng.random(n), rng.random(m)
    jx, tx = _pair(hx, ctx1, tctx)
    jz, tz = _pair(hz, ctx1, tctx)
    jy, ty = _out(m, np.float64, ctx1, tctx)
    jy[:] = vex.reshape(jx, dst, order=order)
    ty[:] = vt.reshape(tx, dst, order=order)
    _exact(ty.to_numpy(), jy.to_numpy())
    jy[:] = vex.reshape(jx, dst, order=order) + jz
    ty[:] = vt.reshape(tx, dst, order=order) + tz
    _exact(ty.to_numpy(), jy.to_numpy())


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("shape,axis", [((4096, 33), 0), ((3, 5000), 0),
                                        ((20000, 1), 0), ((20000, 1), (0, 1)),
                                        ((64, 512, 3), (0, 1))])
def test_slice_reduce_split_shapes(ctx1, tctx, op, shape, axis):
    """The shapes whose reduced range the CUDA kernel splits; factors
    near 1 for products (no underflow), a NaN for min and max."""
    n, nd = int(np.prod(shape)), len(shape)
    rng = np.random.default_rng(7)
    hx = (1 + 1e-3 * (rng.random(n) - 0.5)) if op == "prod" else (
        rng.random(n) + 0.5)
    if op in ("min", "max"):
        hx[n - 1] = np.nan
    jx, tx = _pair(hx, ctx1, tctx)
    want = vex.eval(vex.reduce_view(op, vex.slicer(shape)[(vex._,) * nd](jx),
                                    axis))
    got = vt.eval(vt.reduce_view(op, vt.slicer(shape)[(vt._,) * nd](tx),
                                 axis))
    _close(got, np.ravel(want), RTOL[np.float64])


def test_tensordot_matmul(ctx1, tctx):
    n = 16
    rng = np.random.default_rng(6)
    ha, hb = rng.random(n * n), rng.random(n * n)
    (ja, ta), (jb, tb) = _pair(ha, ctx1, tctx), _pair(hb, ctx1, tctx)
    jc, tc = _out(n * n, np.float64, ctx1, tctx)
    jc[:] = vex.tensordot(vex.slicer((n, n))[:, :](ja),
                          vex.slicer((n, n))[:, :](jb), vex.axes_pairs(1, 0))
    tc[:] = vt.tensordot(vt.slicer((n, n))[:, :](ta),
                         vt.slicer((n, n))[:, :](tb), vt.axes_pairs(1, 0))
    _close(tc.to_numpy(), jc.to_numpy(), 1e-10)


def test_tensordot_mat_vec_and_vec_mat(ctx1, tctx):
    n, m = 32, 24
    rng = np.random.default_rng(7)
    hA, hv = rng.random(n * m), rng.random(m)
    (jA, tA), (jv, tv) = _pair(hA, ctx1, tctx), _pair(hv, ctx1, tctx)
    jy, ty = _out(n, np.float64, ctx1, tctx)
    jy[:] = vex.tensordot(vex.slicer((n, m))[:, :](jA),
                          vex.slicer((m,))[:](jv), vex.axes_pairs(1, 0))
    ty[:] = vt.tensordot(vt.slicer((n, m))[:, :](tA),
                         vt.slicer((m,))[:](tv), vt.axes_pairs(1, 0))
    _close(ty.to_numpy(), jy.to_numpy(), 1e-10)
    jx, tx = _out(n, np.float64, ctx1, tctx)
    jx[:] = vex.tensordot(2 * vex.slicer((m,))[:](jv),
                          vex.slicer((n, m))[:, :](jA), vex.axes_pairs(0, 1))
    tx[:] = vt.tensordot(2 * vt.slicer((m,))[:](tv),
                         vt.slicer((n, m))[:, :](tA), vt.axes_pairs(0, 1))
    _close(tx.to_numpy(), jx.to_numpy(), 1e-10)


@pytest.mark.parametrize("ax", [(1, 0), (-1, 0)])
def test_tensordot_standalone_size(ctx1, tctx, ax):
    n, m, k = 12, 8, 5
    rng = np.random.default_rng(8)
    ha, hb = rng.random(n * m), rng.random(m * k)
    (ja, ta), (jb, tb) = _pair(ha, ctx1, tctx), _pair(hb, ctx1, tctx)
    je = vex.tensordot(vex.slicer((n, m))[:, :](ja),
                       vex.slicer((m, k))[:, :](jb), vex.axes_pairs(*ax))
    te = vt.tensordot(vt.slicer((n, m))[:, :](ta),
                      vt.slicer((m, k))[:, :](tb), vt.axes_pairs(*ax))
    assert te.size_hint() == je.size_hint() == n * k
    _close(vt.eval(te), np.asarray(vex.eval(je)), 1e-10)


def test_view_in_expression(ctx1, tctx):
    hx = np.random.default_rng(9).random(N * N)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(N, np.float64, ctx1, tctx)
    js, ts = vex.slicer((N, N)), vt.slicer((N, N))
    jy[:] = 2 * js[3](jx) + vex.sin(js[:, 4](jx))
    ty[:] = 2 * ts[3](tx) + vt.sin(ts[:, 4](tx))
    _close(ty.to_numpy(), jy.to_numpy())


# -- tests/test_multi_array.py ---------------------------------------------

def test_multi_array_create_and_arithmetics(ctx1, tctx):
    x = vt.multi_array(vt.extents[64][48], dtype=np.float64, context=tctx)
    assert x.size(0) == 64 and x.size(1) == 48 and x.size() == 64 * 48
    assert x[vt.indices[5][vt.range_(0, 40)]].size_hint() == 40
    jx = vex.multi_array(vex.extents[16][16][16], dtype=np.float64,
                         context=ctx1)
    tx = vt.multi_array(vt.extents[16][16][16], dtype=np.float64,
                        context=tctx)
    jy = vex.multi_array((16, 16, 16), dtype=np.float64, context=ctx1)
    ty = vt.multi_array((16, 16, 16), dtype=np.float64, context=tctx)
    jx.vec()[:] = 2 * np.pi * vex.element_index() / jx.size()
    tx.vec()[:] = 2 * np.pi * vt.element_index() / tx.size()
    jy.vec()[:] = vex.sin(jx.vec()) ** 2 + vex.cos(jx.vec()) ** 2
    ty.vec()[:] = vt.sin(tx.vec()) ** 2 + vt.cos(tx.vec()) ** 2
    _close(np.asarray(ty), np.asarray(jy))


def test_multi_array_slicing(ctx1, tctx):
    n = 8
    jx, tx, jy, ty = (
        pkg.multi_array(pkg.extents[n][n][n], dtype=np.float64, context=c)
        for pkg, c in ((vex, ctx1), (vt, tctx), (vex, ctx1), (vt, tctx)))
    for pkg, x, y in ((vex, jx, jy), (vt, tx, ty)):
        _u = pkg._
        x.vec()[:] = 0.0
        y.vec()[:] = 0.0
        for i in range(n):
            x[pkg.indices[i][_u][_u]].assign(float(i))
        for i in range(n):
            y[pkg.indices[_u][_u][i]] = x[pkg.indices[i][_u][_u]]
    idx = np.arange(n ** 3).reshape(n, n, n)
    _exact(np.asarray(ty), (idx % n).astype(np.float64))
    _exact(np.asarray(ty), np.asarray(jy))


def test_multi_array_reducing(ctx1, tctx):
    jx = vex.multi_array(vex.extents[16][16][16], dtype=np.int32,
                         context=ctx1)
    tx = vt.multi_array(vt.extents[16][16][16], dtype=np.int32, context=tctx)
    jx.vec()[:] = 1
    tx.vec()[:] = 1
    for ax in (0, 1, 2):
        want = vex.eval(vex.reduce_view("SUM", jx, ax))
        got = vt.eval(vt.reduce_view("SUM", tx, ax))
        assert np.dtype(str(got.dtype).replace("torch.", "")) == want.dtype
        _exact(got, want)


def test_multi_array_host_data_and_setitem(ctx1, tctx):
    h = np.arange(24.0).reshape(2, 3, 4)
    jm = vex.multi_array(None, data=h, context=ctx1)
    tm = vt.multi_array(None, data=np.asarray(jm), context=tctx)
    assert tm.shape == (2, 3, 4)
    _exact(np.asarray(tm), h)
    jm[1, vex._, vex._] = 0.0
    tm[1, vt._, vt._] = 0.0
    _exact(np.asarray(tm), np.asarray(jm))
    jsub = vex.eval(jm[vex.indices[vex._][1][vex.range_(0, 2)]])
    tsub = vt.eval(tm[vt.indices[vt._][1][vt.range_(0, 2)]])
    _exact(tsub, np.asarray(jsub))


# -- tests/test_pointer_util.py --------------------------------------------

def test_raw_pointer_nbody(ctx1, tctx):
    n = 512
    hx = np.random.default_rng(10).random(n)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(n, np.float64, ctx1, tctx)
    ji, ti = vex.element_index(0, n), vt.element_index(0, n)
    jy[:] = vex.raw_pointer(jx)[(ji * 7 + 3) % n] + jx
    ty[:] = vt.raw_pointer(tx)[(ti * 7 + 3) % n] + tx
    _exact(ty.to_numpy(), jy.to_numpy())


def test_constant_pointer(ctx1, tctx):
    hx = np.random.default_rng(11).random(16)
    jx, tx = _pair(hx, ctx1, tctx)
    jy, ty = _out(64, np.float64, ctx1, tctx)
    jy[:] = vex.constant_pointer(jx)[vex.element_index(0, 64) % 16]
    ty[:] = vt.constant_pointer(tx)[vt.element_index(0, 64) % 16]
    _exact(ty.to_numpy(), jy.to_numpy())


@pytest.mark.parametrize("n", [1, 17, 32, 1000])
def test_util_functions(n):
    assert vt.nextpow2(n) == vex.nextpow2(n)
    assert vt.alignup(n, 8) == vex.alignup(n, 8)
    with pytest.raises(ValueError):
        vt.precondition(False, "boom")


def test_manual_stencil_pointer_arithmetic(ctx1, tctx):
    n = 1024
    hx = np.random.default_rng(12).random(n)
    outs = []
    for pkg, c in ((vex, ctx1), (vt, tctx)):
        x = pkg.vector(data=hx, context=c)
        p = pkg.raw_pointer(x)
        i = pkg.make_temp(1, pkg.element_index(length=n))
        left = pkg.make_temp(2, pkg.if_else(i > 0, i - 1, i))
        right = pkg.make_temp(3, pkg.if_else(i + 1 < n, i + 1, i))
        y = pkg.vector(n, dtype=np.float64, context=c)
        y[:] = p[i] * 2 - p[left] - p[right]
        outs.append(np.asarray(y))
    _close(outs[1], outs[0])


# -- nested views, tie, Reductor ---------------------------------------------

def test_nested_views(ctx1, tctx):
    rng = np.random.default_rng(13)
    hx = rng.random(N * N)
    hp = rng.permutation(N).astype(np.int64)
    jx, tx = _pair(hx, ctx1, tctx)
    jp, tp = _pair(hp, ctx1, tctx)
    jy, ty = _out(N, np.float64, ctx1, tctx)
    # a permutation of a row of a transpose
    jy[:] = vex.permutation(jp)(vex.slicer((N, N))[2](
        vex.reshape(jx, (N, N), (1, 0))))
    ty[:] = vt.permutation(tp)(vt.slicer((N, N))[2](
        vt.reshape(tx, (N, N), (1, 0))))
    _exact(ty.to_numpy(), hx.reshape(N, N).T[2][hp])
    _exact(ty.to_numpy(), jy.to_numpy())
    # a slice of an expression of a slice
    from vexcl_tpu.expr.view import SliceTerminal as JaxSlice

    jz, tz = _out(8, np.float64, ctx1, tctx)
    jz[:] = JaxSlice(2 * jx[N:3 * N], slice(4, 20, 2))
    tz[:] = vt.SliceTerminal(2 * tx[N:3 * N], slice(4, 20, 2))
    _exact(tz.to_numpy(), jz.to_numpy())
    _exact(tz.to_numpy(), 2 * hx[N:3 * N][4:20:2])


def test_views_in_tie_and_reductor(ctx1, tctx):
    hx = np.random.default_rng(14).random(N * N)
    jx, tx = _pair(hx, ctx1, tctx)
    (ja, ta), (jb, tb) = (_out(N, np.float64, ctx1, tctx) for _ in range(2))
    vex.tie(ja, jb).assign((vex.slicer((N, N))[1](jx),
                            vex.slicer((N, N))[:, 2](jx) * 3))
    vt.tie(ta, tb).assign((vt.slicer((N, N))[1](tx),
                           vt.slicer((N, N))[:, 2](tx) * 3))
    _exact(ta.to_numpy(), ja.to_numpy())
    _exact(tb.to_numpy(), jb.to_numpy())
    for kind in ("SUM", "MIN", "MAX"):
        want = vex.Reductor(getattr(vex, kind))(vex.slicer((N, N))[3](jx))
        got = vt.Reductor(getattr(vt, kind))(vt.slicer((N, N))[3](tx))
        _close(got, want)
    mm = vt.Reductor(vt.MIN_MAX)(tx[5:50:3])
    assert mm == (hx[5:50:3].min(), hx[5:50:3].max())


# -- assignment through views ------------------------------------------------

@pytest.mark.parametrize("op", ["=", "+=", "-=", "*=", "/="])
def test_assign_through_slices(ctx1, tctx, op):
    rng = np.random.default_rng(15)
    hx, hv = rng.random(N * N) + 0.5, rng.random(N) + 0.5
    for key in ((4, slice(None)), (slice(2, 30, 3), 7)):
        (jx, tx), (jv, tv) = _pair(hx, ctx1, tctx), _pair(hv, ctx1, tctx)
        n = np.ravel(hx.reshape(N, N)[key]).size
        vex.slicer((N, N))[key](jx).assign(jv[0:n] * 2, op)
        vt.slicer((N, N))[key](tx).assign(tv[0:n] * 2, op)
        _close(tx.to_numpy(), jx.to_numpy())
    (jx, tx), (jv, tv) = _pair(hx, ctx1, tctx), _pair(hv, ctx1, tctx)
    if op == "=":
        jx[100:132] = jv
        tx[100:132] = tv
        _exact(tx.to_numpy(), jx.to_numpy())


@pytest.mark.parametrize("op", ["=", "+=", "*=", "-=", "/="])
@pytest.mark.parametrize("dt", [np.float64, np.int32])
def test_assign_through_permutation(ctx1, tctx, op, dt):
    """Unique indices for every op; repeated ones accumulate for += (and
    multiply for *=), as ``.at[idx].add``."""
    rng = np.random.default_rng(16)
    hy = rng.integers(1, 5, 64).astype(dt)
    hv = rng.integers(1, 4, 40).astype(dt)
    for hp in (rng.permutation(64)[:40], rng.integers(0, 16, 40)):
        if op not in ("+=", "*=") and len(np.unique(hp)) < len(hp):
            continue
        (jy, ty), (jv, tv) = _pair(hy, ctx1, tctx), _pair(hv, ctx1, tctx)
        (jp, tp) = _pair(hp.astype(np.int32), ctx1, tctx)
        vex.permutation(jp)(jy).assign(jv, op)
        vt.permutation(tp)(ty).assign(tv, op)
        _close(ty.to_numpy(), jy.to_numpy())


def test_setitem_with_index_array(ctx1, tctx):
    hx = np.random.default_rng(17).random(32)
    jx, tx = _pair(hx, ctx1, tctx)
    idx = np.array([3, -1, 7, 0])
    jx[idx] = 2 * jx[0:4]
    tx[idx] = 2 * tx[0:4]
    _exact(tx.to_numpy(), jx.to_numpy())
    tx[np.array([1, 2])] = 5.0
    assert tx[1] == tx[2] == 5.0
    with pytest.raises(IndexError):
        tx[np.array([1, 32])] = 0.0
    with pytest.raises(IndexError):
        tx[np.array([-33])] = 0.0


_ADV_DIMS = (6, 7, 5)
_ADV_I = np.array([0, 5, -1, 9, -8, 2, 3])        # out of range: 9, -8
_ADV_J = np.array([6, 0, 3, -2, 11, 1, 4])
_ADV_KEYS = {
    "array_int": lambda i, j, o, m: (i, 2),
    "int_array": lambda i, j, o, m: (3, i),
    "arrays_adjacent": lambda i, j, o, m: (i, j),
    "arrays_adjacent_last": lambda i, j, o, m: (m._, i, o),
    "arrays_separated": lambda i, j, o, m: (i, m._, o),
    "int_separated": lambda i, j, o, m: (1, m._, i),
    "array_int_array": lambda i, j, o, m: (i, 4, o),
    "one_broadcast": lambda i, j, o, m: (o, j),
    "range_array_int": lambda i, j, o, m: (m.r(1, 5), j, 3),
}


@pytest.mark.parametrize("key", sorted(_ADV_KEYS))
@pytest.mark.parametrize("dt", [np.float64, np.int32])
def test_slicer_advanced_keys(ctx1, tctx, key, dt):
    """Index arrays beside integers and beside each other (numpy's
    advanced indexing: broadcast together, their axis in place where they
    are adjacent, first where a slice separates them), out-of-range
    indices wrapped and clamped; against the JAX package and numpy."""
    hx = np.random.default_rng(19).integers(-99, 99, 210).astype(dt)
    jx, tx = _pair(hx, ctx1, tctx)
    hk = [_ADV_I, _ADV_J, np.array([4])]
    dims = _ADV_DIMS
    ref_key = _ADV_KEYS[key](*hk, type("np_", (), {"_": slice(None),
                                                   "r": _np_range}))
    clamped = []
    for d, part in zip(dims, ref_key):
        if isinstance(part, np.ndarray):
            part = np.clip(np.where(part < 0, part + d, part), 0, d - 1)
        clamped.append(part)
    want = hx.reshape(dims)[tuple(clamped)].ravel()
    outs = []
    for m, x, c in ((vex, jx, ctx1), (vt, tx, tctx)):
        keys = [m.vector(data=a, context=c) for a in hk]
        y = m.vector(want.size, dtype=dt, context=c)
        y[:] = m.slicer(dims)[_ADV_KEYS[key](*keys, m)](x) * 2 + 1
        outs.append(np.asarray(y.to_numpy() if m is vt else y))
    _exact(outs[1], outs[0])
    _exact(outs[1], want * 2 + 1)


def _np_range(start, stop):
    return slice(start, stop)


@pytest.mark.parametrize("kind", ["add", "sub", "min", "max"])
@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32, np.int64])
def test_atomic_updates(ctx1, tctx, kind, dt):
    rng = np.random.default_rng(18)
    hy = rng.integers(-8, 8, 16).astype(dt)
    hk = rng.integers(0, 16, 200).astype(np.int32)
    hv = rng.integers(-9, 9, 200).astype(dt)
    (jy, ty), (jk, tk) = _pair(hy, ctx1, tctx), _pair(hk, ctx1, tctx)
    jv, tv = _pair(hv, ctx1, tctx)
    jfn, tfn = getattr(vex, f"atomic_{kind}"), getattr(vt, f"atomic_{kind}")
    vex.eval(jfn(vex.permutation(jk)(jy), jv))
    got = vt.eval(tfn(vt.permutation(tk)(ty), tv))
    assert got is ty
    _exact(ty.to_numpy(), jy.to_numpy())
    # the reference's histogram: atomic_add of a constant
    vex.eval(vex.atomic_add(vex.permutation(jk)(jy), 1))
    vt.eval(vt.atomic_add(vt.permutation(tk)(ty), 1))
    _exact(ty.to_numpy(), jy.to_numpy())


# -- out of range --------------------------------------------------------------

@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32, np.int64,
                                np.uint32, np.int8])
def test_out_of_range_reads(ctx1, tctx, dt):
    """A key wraps negatives and clamps; a permutation (and a pointer)
    wraps negatives and reads NaN or the least signed / the largest
    unsigned integer."""
    hb = np.arange(16).astype(dt)
    jb, tb = _pair(hb, ctx1, tctx)
    hi = np.array([-1, 20, 3, -20, -16, 16])
    ji, ti = _pair(hi, ctx1, tctx)
    jo, to = _out(6, dt, ctx1, tctx)
    jo[:] = jb[hi]
    to[:] = tb[hi]
    _exact(to.to_numpy(), jo.to_numpy())
    jo[:] = vex.permutation(ji)(jb)
    to[:] = vt.permutation(ti)(tb)
    _exact(to.to_numpy(), jo.to_numpy())
    jo[:] = vex.raw_pointer(jb)[ji]
    to[:] = vt.raw_pointer(tb)[ti]
    _exact(to.to_numpy(), jo.to_numpy())
    # static integer keys clamp too
    jo[:] = vex.slicer((4, 4))[5, -9](jb)
    to[:] = vt.slicer((4, 4))[5, -9](tb)
    _exact(to.to_numpy(), jo.to_numpy())


def test_out_of_range_writes_are_dropped(ctx1, tctx):
    hy = np.zeros(5)
    hp = np.array([1, 1, 6, -1, -7], dtype=np.int32)
    (jy, ty), (jp, tp) = _pair(hy, ctx1, tctx), _pair(hp, ctx1, tctx)
    vex.eval(vex.atomic_add(vex.permutation(jp)(jy), 1))
    vt.eval(vt.atomic_add(vt.permutation(tp)(ty), 1))
    _exact(ty.to_numpy(), jy.to_numpy())
    _exact(ty.to_numpy(), [0, 2, 0, 0, 1])
    hv = np.array([1.0, 2, 3, 4, 5])
    jv, tv = _pair(hv, ctx1, tctx)
    hp2 = np.array([0, 2, 6, -1, -7], dtype=np.int32)
    jp2, tp2 = _pair(hp2, ctx1, tctx)
    vex.permutation(jp2)(jy).assign(jv)
    vt.permutation(tp2)(ty).assign(tv)
    _exact(ty.to_numpy(), jy.to_numpy())


def test_view_size_mismatch_raises(tctx):
    x = vt.vector(data=np.arange(16.0), context=tctx)
    y = vt.vector(8, dtype=np.float64, context=tctx)
    with pytest.raises(ValueError):
        y[:] = x[0:5]
    with pytest.raises(ValueError):
        y[:] = vt.slicer((5, 3))[:, 1](x)   # 15 != 16 elements viewed


# -- reduce_view's result types ----------------------------------------------

@pytest.mark.parametrize("dt", [np.bool_, np.int8, np.uint8, np.int32,
                                np.uint32, np.int64, np.float32, np.float64])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
def test_reduce_view_types(ctx1, tctx, dt, op):
    rng = np.random.default_rng(19)
    h = (rng.integers(0, 2, 4 * 6) if dt == np.bool_
         else rng.integers(1, 4, 4 * 6)).astype(dt)
    jx, tx = _pair(h, ctx1, tctx)
    want = np.asarray(vex.eval(vex.reduce_view(
        op, vex.slicer((4, 6))[:, :](jx), 1)))
    got = vt.eval(vt.reduce_view(op, vt.slicer((4, 6))[:, :](tx), 1))
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    _close(got.double().numpy(), want.astype(np.float64),
           RTOL.get(dt, 0.0))


def test_reduce_view_nan_and_3d(ctx1, tctx):
    h = np.random.default_rng(20).random(6 * 5 * 4)
    h[7] = np.nan
    jx, tx = _pair(h, ctx1, tctx)
    for op in ("sum", "min", "max"):
        for axes in ((0,), (2,), (0, 2), (1,)):
            want = vex.eval(vex.reduce_view(
                op, vex.slicer((6, 5, 4))[:, :, :](jx), axes))
            got = vt.eval(vt.reduce_view(
                op, vt.slicer((6, 5, 4))[:, :, :](tx), axes))
            _close(got, np.ravel(want), RTOL[np.float64])


# -- aliasing: the target read through a view ----------------------------------

def test_aliasing_targets(ctx1, tctx):
    """Each case reads old values, as the JAX package does."""
    rng = np.random.default_rng(21)
    hx = rng.random(N * N)
    hp = rng.permutation(N * N).astype(np.int32)
    jp, tp = _pair(hp, ctx1, tctx)
    cases = [
        lambda pkg, x, p: x.assign(pkg.permutation(p)(x)),
        lambda pkg, x, p: x.__setitem__(slice(1, None), x[:-1]),
        lambda pkg, x, p: x.assign(pkg.reshape(x, (N, N), (1, 0))),
        lambda pkg, x, p: x.assign(x + pkg.permutation(p)(x), "+="),
        lambda pkg, x, p: pkg.slicer((N, N))[:, 3](x).assign(
            pkg.slicer((N, N))[3](x)),
        lambda pkg, x, p: x.__setitem__(slice(0, N), pkg.reduce_view(
            "sum", pkg.slicer((N, N))[:, :](x), 1)),
    ]
    for case in cases:
        (jx, tx) = _pair(hx, ctx1, tctx)
        case(vex, jx, jp)
        case(vt, tx, tp)
        _close(tx.to_numpy(), jx.to_numpy())


# -- gather / scatter, any_of / all_of ------------------------------------------

def test_gather_scatter(ctx1, tctx):
    rng = np.random.default_rng(22)
    hx = rng.random(100)
    jx, tx = _pair(hx, ctx1, tctx)
    idx = np.array([5, 99, 0, 42, -1])
    _exact(vt.gather(tx, idx), vex.gather(jx, idx))
    g = vt.Gather(tctx, idx)
    dst = np.zeros(7)
    assert g(tx, dst) is dst
    _exact(dst[:5], hx[idx])
    vals = rng.random(5)
    vex.scatter(vals, idx, jx)
    vt.scatter(vals, idx, tx)
    _exact(tx.to_numpy(), jx.to_numpy())
    vt.Scatter(tctx, [1, 2]).put([7.0, 8.0], tx)
    assert (tx[1], tx[2]) == (7.0, 8.0)


def test_any_all(ctx1, tctx):
    h = np.zeros(50)
    jx, tx = _pair(h, ctx1, tctx)
    assert vt.any_of(tx) is vex.any_of(jx) is False
    assert vt.all_of(tx == 0) is vex.all_of(jx == 0) is True
    h[17] = np.nan
    jx, tx = _pair(h, ctx1, tctx)
    assert vt.any_of(tx) is vex.any_of(jx) is True
    assert vt.all_of(tx) is vex.all_of(jx) is False
    assert vt.all_of(tx[17:18]) is vex.all_of(jx[17:18]) is True
    assert vt.any_of(tx > 0.5) is vex.any_of(jx > 0.5) is False


# -- seeded smoke versions of exp/fuzz_views.py and exp/fuzz_donate.py ----------

def _rand_key(rng, dims):
    key = []
    for d in dims:
        if rng.random() < 0.7:
            start = int(rng.integers(0, d))
            stop = int(rng.integers(start + 1, d + 1))
            key.append(slice(start, stop, int(rng.integers(1, 4))))
        else:
            key.append(int(rng.integers(0, d)))
    return tuple(key)


def test_fuzz_views_smoke(ctx1, tctx):
    rng = np.random.default_rng(0)
    shapes = [(64,), (40,), (8, 16), (16, 8), (7, 9), (4, 6, 8), (3, 5, 7)]
    for dims in shapes * 2:
        n = int(np.prod(dims))
        ha = rng.normal(size=n).astype(np.float32)
        key = _rand_key(rng, dims)
        ref = ha.reshape(dims)[key]
        m = max(int(np.prod(np.shape(ref))), 1)
        (ja, ta) = _pair(ha, ctx1, tctx)
        jo, to = _out(m, np.float32, ctx1, tctx)
        jo[:] = vex.slicer(dims)[key](ja) * 2.0 + 1.0
        to[:] = vt.slicer(dims)[key](ta) * 2.0 + 1.0
        _exact(to.to_numpy(), jo.to_numpy())
        _close(to.to_numpy(), np.ravel(ref * 2.0 + 1.0), 1e-6)
        jb, tb = _pair(ha, ctx1, tctx)
        vex.slicer(dims)[key](jb).assign(7.0)
        vt.slicer(dims)[key](tb).assign(7.0)
        refw = ha.copy().reshape(dims)
        refw[key] = 7.0
        _exact(tb.to_numpy(), refw.ravel())
        _exact(tb.to_numpy(), jb.to_numpy())
    for n in (64, 1000, 1003):
        ha = rng.normal(size=n).astype(np.float32)
        idx = rng.permutation(n).astype(np.int32)
        (ja, ta), (ji, ti) = _pair(ha, ctx1, tctx), _pair(idx, ctx1, tctx)
        to = vt.vector(n, dtype=np.float32, context=tctx)
        to[:] = vt.permutation(ti)(ta)
        _exact(to.to_numpy(), ha[idx])
        to[:] = vt.permutation(np.float64(n - 1)
                               - vt.element_index(0, n))(ta)
        _exact(to.to_numpy(), ha[::-1])


def test_fuzz_aliasing_smoke(ctx1, tctx):
    """Random expressions assigned into one of their own operands, whole
    or through a slice, a slicer or a permutation view, with `=` and
    `+=`, against both packages and a numpy mirror; every live vector is
    checked after every step."""
    rng = np.random.default_rng(1)
    n = 64
    hs = [rng.normal(size=n) for _ in range(4)]
    jpool = [vex.vector(data=h.copy(), context=ctx1) for h in hs]
    tpool = [vt.vector(data=h.copy(), context=tctx) for h in hs]
    mirror = [h.copy() for h in hs]
    perm = rng.permutation(n)
    (jperm, tperm) = _pair(perm.astype(np.int32), ctx1, tctx)

    def build(depth, nodes):
        if depth == 0 or rng.random() < 0.3:
            i = int(rng.integers(0, len(mirror)))
            k = rng.random()
            if k < 0.15:
                c = float(rng.normal())
                return [c, c, c]
            if k < 0.35:
                return [vex.permutation(jperm)(jpool[i]),
                        vt.permutation(tperm)(tpool[i]), mirror[i][perm]]
            if k < 0.5:
                return [vex.reshape(jpool[i], (8, 8), (1, 0)),
                        vt.reshape(tpool[i], (8, 8), (1, 0)),
                        mirror[i].reshape(8, 8).T.ravel()]
            return [jpool[i][:], tpool[i][:], mirror[i]]
        a, b = build(depth - 1, nodes), build(depth - 1, nodes)
        op = int(rng.integers(0, 3))
        if op == 0:
            return [x + y for x, y in zip(a, b)]
        if op == 1:
            return [x - y for x, y in zip(a, b)]
        return [x * 0.5 + y * 0.25 for x, y in zip(a, b)]

    for step in range(30):
        t = int(rng.integers(0, len(mirror)))
        je, te, ref = build(int(rng.integers(1, 4)), [])
        ref = np.broadcast_to(ref, (n,)).copy()
        kind = rng.random()
        if kind < 0.3:
            jpool[t][:] = je
            tpool[t][:] = te
            mirror[t] = ref
        elif kind < 0.5:
            jpool[t] += je
            tpool[t] += te
            mirror[t] = mirror[t] + ref
        elif kind < 0.7:
            jpool[t][8:40] = vex.slicer((n,))[0:32](je * 1.0) \
                if not np.isscalar(je) else je
            tpool[t][8:40] = vt.slicer((n,))[0:32](te * 1.0) \
                if not np.isscalar(te) else te
            mirror[t] = mirror[t].copy()
            mirror[t][8:40] = ref[0:32]
        elif kind < 0.85:
            vex.slicer((8, 8))[:, 2](jpool[t]).assign(
                vex.slicer((8, 8))[5](je * 1.0) if not np.isscalar(je)
                else je, "+=")
            vt.slicer((8, 8))[:, 2](tpool[t]).assign(
                vt.slicer((8, 8))[5](te * 1.0) if not np.isscalar(te)
                else te, "+=")
            m = mirror[t].copy().reshape(8, 8)
            m[:, 2] += ref.reshape(8, 8)[5]
            mirror[t] = m.ravel()
        else:
            # the JAX package donates the target's buffer to its scatter
            # while the value still reads it, and fails: it gets the
            # value in a vector of its own
            jtmp = vex.vector(n, dtype=np.float64, context=ctx1)
            jtmp[:] = je
            vex.permutation(jperm)(jpool[t]).assign(jtmp)
            vt.permutation(tperm)(tpool[t]).assign(te)
            m = mirror[t].copy()
            m[perm] = ref
            mirror[t] = m
        for jv, tv, m in zip(jpool, tpool, mirror):
            _close(tv.to_numpy(), m, 1e-10)
            _close(tv.to_numpy(), jv.to_numpy(), 1e-12)
        for i in range(len(mirror)):
            if not np.all(np.abs(mirror[i]) < 1e6):
                h = rng.normal(size=n)
                jpool[i][:] = vex.vector(data=h.copy(), context=ctx1)[:] * 1.0
                tpool[i][:] = vt.vector(data=h.copy(), context=tctx)[:] * 1.0
                mirror[i] = h
