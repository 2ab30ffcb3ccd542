"""Parity of the port's images and mapped vectors with vexcl_tpu.

The cases of ``tests/test_misc_components.py`` (``image2d`` nearest and
linear, the clamp-to-edge sampling outside the image, ``image1d``,
samples inside larger expressions, ``svm_vector``) go through both
packages on the CPU from the same seeded numpy inputs, where the port's
samples run their plain PyTorch forms (the V1 indexed loads of the tree
are checked against them on the card by ``tests/test_torch_cuda.py``).

Tolerances, relative to the largest magnitude: nearest samples exact;
linear ones 1e-12 (f64) and 1e-6 (f32): the JAX package sums its
bilinear patch rows in another order, and numpy's oracle too.
"""

import numpy as np
import pytest

import vexcl_tpu as vex
import vexcl_tpu_torch as vt

RTOL = {np.float64: 1e-12, np.float32: 1e-6}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _sample(m, ctx, img, filt, coords, dt):
    """``img`` sampled at ``coords`` by package m: a vector's values."""
    vs = [m.vector(data=c.astype(dt), context=ctx) for c in coords]
    kw = {"context": ctx} if m is vt else {}
    im = (m.image2d if img.ndim == 2 else m.image1d)(img, filter=filt, **kw)
    out = m.vector(len(coords[0]), dtype=dt, context=ctx)
    out[:] = im(*vs)
    return np.asarray(out.to_numpy() if m is vt else out)


def test_image2d_nearest_linear(ctx1, tctx):
    """The reference's 4x4 case: nearest at whole and half coordinates
    (rounded half to even), bilinear at (2.5, 1.5) the mean of four."""
    img = np.arange(16, dtype=np.float64).reshape(4, 4)
    xs = np.array([0.0, 1.0, 2.5, 3.0])
    ys = np.array([0.0, 2.0, 1.5, 3.0])
    for filt in ("nearest", "linear"):
        want = _sample(vex, ctx1, img, filt, (xs, ys), np.float64)
        got = _sample(vt, tctx, img, filt, (xs, ys), np.float64)
        _close(got, want, RTOL[np.float64])
    near = _sample(vt, tctx, img, "nearest", (xs, ys), np.float64)
    np.testing.assert_array_equal(
        near, img[np.round(ys).astype(int), np.round(xs).astype(int)])
    lin = _sample(vt, tctx, img, "linear", (xs, ys), np.float64)
    assert lin[2] == pytest.approx((img[1, 2] + img[1, 3] + img[2, 2]
                                    + img[2, 3]) / 4)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("filt", ["nearest", "linear"])
def test_image2d_out_of_range_clamps_to_edge(ctx1, tctx, dt, filt):
    """Coordinates inside and outside a 13x9 image, halves and edges:
    clamp-to-edge, against the JAX package and a numpy oracle."""
    rng = np.random.default_rng(20)
    img = rng.random((13, 9)).astype(dt)
    xs = np.concatenate([rng.random(64) * 8, [-1.5, -0.2, 8.0, 9.7, 0.5,
                                              2.5, -7.0, 30.0]])
    ys = np.concatenate([rng.random(64) * 12, [12.9, -0.4, 0.0, 13.5, 1.5,
                                               3.5, 40.0, -2.0]])
    want = _sample(vex, ctx1, img, filt, (xs, ys), dt)
    got = _sample(vt, tctx, img, filt, (xs, ys), dt)
    xs, ys = xs.astype(dt).astype(np.float64), ys.astype(dt).astype(
        np.float64)
    if filt == "nearest":
        np.testing.assert_array_equal(got, want)
        ref = img[np.clip(np.round(ys).astype(int), 0, 12),
                  np.clip(np.round(xs).astype(int), 0, 8)]
        np.testing.assert_array_equal(got, ref)
        return
    _close(got, want, RTOL[dt])
    xc, yc = np.clip(xs, 0, 8), np.clip(ys, 0, 12)
    x0, y0 = np.floor(xc).astype(int), np.floor(yc).astype(int)
    tx, ty = xc - x0, yc - y0
    x1, y1 = np.minimum(x0 + 1, 8), np.minimum(y0 + 1, 12)
    ref = (img[y0, x0] * (1 - tx) * (1 - ty) + img[y0, x1] * tx * (1 - ty)
           + img[y1, x0] * (1 - tx) * ty + img[y1, x1] * tx * ty)
    _close(got, ref, RTOL[dt])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_image1d_nearest_linear(ctx1, tctx, dt):
    """A 1-D image fetched at computed indices (nearest) and halfway
    between texels and outside (linear)."""
    rng = np.random.default_rng(21)
    m, n = 16, 1024
    img = rng.random(m).astype(dt)
    p = (np.arange(n) % m).astype(np.float64)
    xs = np.concatenate([np.linspace(0, m - 1, n - 6),
                         [-3.0, -0.5, 15.5, 16.0, 40.0, 7.5]])
    for filt, coords in (("nearest", p), ("nearest", xs), ("linear", xs)):
        want = _sample(vex, ctx1, img, filt, (coords,), dt)
        got = _sample(vt, tctx, img, filt, (coords,), dt)
        if filt == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, RTOL[dt])
    np.testing.assert_array_equal(
        _sample(vt, tctx, img, "nearest", (p,), dt), img[np.arange(n) % m])


def test_images_compose_in_expressions(ctx1, tctx):
    """Samples inside larger trees: ``2 * img(idx) + a`` and a 2-D sample
    at computed coordinates beside a 1-D one."""
    rng = np.random.default_rng(22)
    im1, im2 = rng.random(8), rng.random((5, 7))
    h_idx, h_a = np.arange(64, dtype=np.float64) % 8, rng.random(64)
    outs = []
    for m, c in ((vex, ctx1), (vt, tctx)):
        kw = {"context": c} if m is vt else {}
        i1 = m.image1d(im1, filter="nearest", **kw)
        i2 = m.image2d(im2, filter="linear", **kw)
        idx = m.vector(data=h_idx, context=c)
        a = m.vector(data=h_a, context=c)
        out = m.vector(64, dtype=np.float64, context=c)
        out[:] = 2 * i1(idx) + a + i2(a * 6, idx * 0.5) * i1(idx + 1)
        outs.append(np.asarray(out.to_numpy() if m is vt else out))
    _close(outs[1], outs[0], RTOL[np.float64])


@pytest.mark.parametrize("table", [np.float32, np.float64, np.float16,
                                   np.int32, np.uint16, np.bool_,
                                   np.complex64])
def test_image_kernel_source(tctx, table):
    """A sample is one node over the table and its coordinates: the
    assignment kernel's source for each filter, table type and coordinate
    type (f32, f16, i32, bool, a Python float) parses, and loads the table
    once a tap (one for nearest, two or four for linear)."""
    import ast

    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import assign_source

    rng = np.random.default_rng(23)
    n = 32
    img = (rng.random((3, 4)) * 5).astype(table)
    coords = [vt.vector(data=(rng.random(n) * 5).astype(dt), context=tctx)
              for dt in (np.float32, np.float16)]
    coords += [vt.vector(data=np.arange(n, dtype=np.int32), context=tctx),
               vt.vector(data=np.arange(n) % 2 == 0, context=tctx), 2.5]
    for filt, taps in (("nearest", (1, 1)), ("linear", (2, 4))):
        im1 = vt.image1d(img[0], filter=filt, context=tctx)
        im2 = vt.image2d(img, filter=filt, context=tctx)
        for x in coords:
            y = coords[0]
            for expr, k in ((im1(y if isinstance(x, float) else x), taps[0]),
                            (im2(x, y), taps[1])):
                e, an, ty, _ = prepare(expr, n, tctx.device)
                src = assign_source(e, an, ty, ty[id(e)])
                ast.parse(src)
                loads = [ln for ln in src.splitlines()
                         if "tl.load(p0 " in ln]
                assert len(loads) == k, src


def test_svm_vector(ctx1, tctx):
    """map() gives a host mirror, unmap() writes it back; ``with v as
    host`` does both; the vector is a vector in expressions."""
    outs = []
    for m, c in ((vex, ctx1), (vt, tctx)):
        v = m.svm_vector(16, dtype=np.float64, context=c)
        with v as host:
            host[:] = np.arange(16)
        h = v.map()
        h[3] = 100.0
        v.unmap()
        y = m.vector(16, dtype=np.float64, context=c)
        y[:] = 2 * v + 1
        outs.append((np.asarray(v.to_numpy() if m is vt else v),
                     np.asarray(y.to_numpy() if m is vt else y)))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
    assert outs[1][0][3] == 100.0
    assert isinstance(vt.svm_vector(4, context=tctx), vt.vector)


def test_linear_sample_launch_shape(tctx):
    """An assignment kernel over a linear sample launches one element a
    thread (``image._LINEAR_SHAPE``); over a nearest one, or none, the
    default shape."""
    from vexcl_tpu_torch.expr.triton_emit import ASSIGN_BLOCK, launch_shape
    from vexcl_tpu_torch.ops.image import _LINEAR_SHAPE

    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    x = vt.vector(data=np.linspace(0, 3, 16, dtype=np.float32),
                  context=tctx)
    lin = vt.image2d(img, filter="linear", context=tctx)
    near = vt.image1d(img[0], filter="nearest", context=tctx)
    assert launch_shape([2 * x + lin(x, x)]) == _LINEAR_SHAPE
    assert launch_shape([vt.as_expr(x), near(x) + lin(x, x)]) == _LINEAR_SHAPE
    assert launch_shape([near(x) * x]) == (ASSIGN_BLOCK, 4)
    out = vt.vector(16, dtype=np.float32, context=tctx)
    out[:] = 2 * x + lin(x, x)
    want = 2 * x.to_numpy() + np.asarray(vt.eval(lin(x, x)))
    np.testing.assert_allclose(out.to_numpy(), want, rtol=1e-6)
