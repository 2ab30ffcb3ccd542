"""Parity of the port's images and mapped vectors with vexcl_tpu.

The cases of ``tests/test_misc_components.py`` (``image2d`` nearest and
linear, the clamp-to-edge sampling outside the image, ``image1d``,
samples inside larger expressions, ``svm_vector``) go through both
packages on the CPU from the same seeded numpy inputs, where the port's
samples run their plain PyTorch forms (the V1 indexed loads of the tree
are checked against them on the card by ``tests/test_torch_cuda_views.py``).

Tolerances, relative to the largest magnitude: nearest samples exact;
linear ones 1e-12 (f64) and 1e-6 (f32): the JAX package sums its
bilinear patch rows in another order, and numpy's oracle too.
"""

import numpy as np
import torch
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


# -- the patch table, and the gather at a computed flat index -------------

def _jax_patch(img):
    """The JAX package's patch table of ``img`` (its 64 MB budget takes
    these sizes)."""
    im = vex.image2d(img, filter="linear")
    im._ensure_patch()
    assert im._patch_dev is not None
    return np.asarray(im._patch_dev)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 2), (13, 9),
                                   (6, 17)])
@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32])
def test_patch_table_matches_jax(shape, dt):
    """The port's table (``image.patch_table``: row y*w + x, the four
    edge-clamped texels) against the JAX package's ``_patch_dev``,
    bitwise, including one row and one column."""
    from vexcl_tpu_torch.ops.image import patch_table

    img = (np.random.default_rng(31).standard_normal(shape) * 100).astype(dt)
    got = patch_table(torch.from_numpy(img)).view(-1, 4).numpy()
    np.testing.assert_array_equal(got, _jax_patch(img))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_patched_plain_form_matches_jax_patched(ctx1, tctx, dt,
                                                monkeypatch):
    """A linear sample forced to the patch table: its plain form against
    the JAX package's patched ``Image2DSample`` within RTOL (the JAX
    package sums each row first), and bitwise against the four taps'
    plain form (the same texels, the same lerp)."""
    from vexcl_tpu_torch.ops import image

    rng = np.random.default_rng(32)
    img = rng.standard_normal((11, 7)).astype(dt)
    xs = np.concatenate([rng.uniform(-2, 9, 200), [0, 6, 6.5, -1, 3.5]])
    ys = np.concatenate([rng.uniform(-2, 13, 200), [0, 10, 10.5, 3.5, -9]])
    assert vex.image2d(img, filter="linear")(
        vex.vector(data=xs), vex.vector(data=ys))._patched
    want = _sample(vex, ctx1, img, "linear", (xs, ys), dt)
    got = {}
    for form in ("patch", "taps"):
        monkeypatch.setattr(image, "FORCE", form)
        got[form] = _sample(vt, tctx, img, "linear", (xs, ys), dt)
    _close(got["patch"], want, RTOL[dt])
    np.testing.assert_array_equal(got["patch"], got["taps"])


def _flat_index(expr, n, ctx):
    """The fused variant's flat index in tensor code
    (``cuda_gather.coords_index`` of the view's ``flat_coords``) for
    ``expr``, and the table it reads."""
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.ops.cuda_gather import Coords, coords_index

    e, an, ty, lv = prepare(expr, n, ctx.device)
    a, b, dims, strides, base, _ = e.flat_coords()

    def leaf(c):
        return lv[an.slot_of[id(c)]]
    idx = coords_index(Coords(leaf(a), leaf(b), dims, strides, base))
    assert idx.dtype == torch.int64
    return idx, leaf(e.children[0])


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_nearest_flat_index_matches_jax(ctx1, tctx, dt):
    """The flat index of nearest 2-D samples at negative, out-of-range,
    huge, NaN and half-way coordinates: the table read there against the
    JAX package's samples, bitwise."""
    rng = np.random.default_rng(33)
    img = rng.standard_normal((13, 9)).astype(dt)
    odd = [-0.5, 0.5, 1.5, 2.5, 7.5, 8.5, 11.5, 12.5, -7.0, 40.0, 3e9,
           -3e9, np.nan, np.inf, -np.inf, 4.4999]
    xs = np.concatenate([rng.uniform(-3, 12, 300), odd, odd[::-1]])
    ys = np.concatenate([rng.uniform(-3, 16, 300), odd[::-1], odd])
    want = _sample(vex, ctx1, img, "nearest", (xs, ys), dt)
    X = vt.vector(data=xs.astype(dt), context=tctx)
    Y = vt.vector(data=ys.astype(dt), context=tctx)
    im = vt.image2d(img, filter="nearest", context=tctx)
    idx, table = _flat_index(im(X, Y), xs.size, tctx)
    np.testing.assert_array_equal(table[idx].numpy(), want)
    np.testing.assert_array_equal(
        _sample(vt, tctx, img, "nearest", (xs, ys), dt), want)


@pytest.mark.parametrize("key", ["ij", "ji_int", "int_i_j"])
def test_slicer_flat_index_matches_jax(ctx1, tctx, key):
    """The flat index of ``slicer(dims)[i, j]`` (and beside an integer)
    with negative keys (wrapped), keys beyond either end (clamped), both
    index types: the vector read there against the JAX package's view,
    bitwise."""
    dims = (37, 41) if key != "int_i_j" else (3, 37, 41)
    hx = np.random.default_rng(34).standard_normal(
        int(np.prod(dims))).astype(np.float32)
    hi = np.array([0, 36, -1, -37, -38, 37, 90, 5, -200, 17])
    hj = np.array([40, 0, -41, -42, 41, 7, -1, 1000, 3, 2])
    keys = {"ij": lambda i, j: (i, j), "ji_int": lambda i, j: (j, i),
            "int_i_j": lambda i, j: (2, i, j)}[key]
    outs = []
    for m, c in ((vex, ctx1), (vt, tctx)):
        x = m.vector(data=hx, context=c)
        i = m.vector(data=hi.astype(np.int32), context=c)
        j = m.vector(data=hj.astype(np.int64), context=c)
        view = m.slicer(dims)[keys(i, j)](x)
        if m is vt:
            idx, table = _flat_index(view, hi.size, c)
            outs.append(table[idx].numpy())
            continue
        y = m.vector(hi.size, dtype=np.float32, context=c)
        y[:] = view
        outs.append(np.asarray(y))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_patch_table_rebuilt_after_in_place_write(tctx, monkeypatch):
    """An image taken from a tensor as it is: a write into the tensor in
    place moves its version, and the next analysis rebuilds the table in
    place (the same tensor); samples read the new texels.  A kernel record
    of the generator keeps the table and brings it up to date before each
    launch."""
    from vexcl_tpu_torch.ops import image

    monkeypatch.setattr(image, "FORCE", "patch")
    data = torch.from_numpy(np.arange(20, dtype=np.float32).reshape(4, 5))
    im = vt.image2d(data, filter="linear", context=tctx)
    assert im.data is data
    x = vt.vector(data=np.array([0.0, 3.5, 4.0], np.float32), context=tctx)
    y = vt.vector(data=np.array([0.0, 2.5, 3.0], np.float32), context=tctx)
    out = vt.vector(3, dtype=np.float32, context=tctx)
    out[:] = im(x, y)
    table = im.patch()
    np.testing.assert_array_equal(out.to_numpy(), [0.0, 16.0, 19.0])
    data[3, 4] = 100.0
    data[0, 0] += 1.0
    expr = im(x, y)
    out[:] = expr
    assert im.patch() is table
    np.testing.assert_array_equal(
        table.numpy(), image.patch_table(data).numpy())
    np.testing.assert_array_equal(out.to_numpy(), [1.0, 36.25, 100.0])
    gen = vt.generator
    a, b, o = gen.symbolic(), gen.symbolic(), gen.symbolic()
    o.assign(im(a, b))
    k = gen.build_kernel("sample", [o], [o, a, b])
    k(out, x, y)
    assert [r is not None for r in k._bindings.values()] == [True]
    data[3, 4] = 7.0
    k(out, x, y)
    np.testing.assert_array_equal(out.to_numpy(), [1.0, 13.0, 7.0])


def test_kernel_writes_move_the_version_the_table_keys_on(tctx,
                                                          monkeypatch):
    """A generated kernel's launch moves the ``_version`` of the tensors
    it writes (``_build.written``), as PyTorch's in-place operations do
    (the launch is faked: no card here); a write that does not move it
    (through numpy, as a kernel writes through ``data_ptr``) is seen by
    the patch table once ``written`` marks it."""
    from vexcl_tpu_torch._build import written
    from vexcl_tpu_torch.expr.triton_emit import _AssignKernel
    from vexcl_tpu_torch.ops import image

    k = object.__new__(_AssignKernel)
    k.tiled, k.consts = False, (1024,)
    calls = []
    k.launcher = lambda *a: calls.append(a)
    outs = [torch.zeros(8), torch.zeros(8)]
    before = [t._version for t in outs]
    k.launch(outs, [], 8)
    assert len(calls) == 1
    assert [t._version for t in outs] == [v + 1 for v in before]
    monkeypatch.setattr(image, "FORCE", "patch")
    data = torch.zeros(3, 4)
    im = vt.image2d(data, filter="linear", context=tctx)
    x = vt.vector(data=np.array([3.0, 0.0], np.float32), context=tctx)
    y = vt.vector(data=np.array([2.0, 0.0], np.float32), context=tctx)
    out = vt.vector(2, dtype=np.float32, context=tctx)
    out[:] = im(x, y)
    data.numpy()[2, 3] = 5.0
    out[:] = im(x, y)
    np.testing.assert_array_equal(out.to_numpy(), [0.0, 0.0])
    written(data)
    out[:] = im(x, y)
    np.testing.assert_array_equal(out.to_numpy(), [5.0, 0.0])


def test_patch_and_index_routes():
    """The routes are pure functions of sizes and types: the patch table
    for f32 and f64 images within the budget (4 x 4096^2 f32 is 256 MiB),
    the gather form's fused variant where the form takes the table from
    the route's thresholds."""
    from vexcl_tpu_torch.ops import cuda_gather
    from vexcl_tpu_torch.ops.image import (PATCH_MIN_BYTES, PATCH_TYPES,
                                           patch_route)

    g = 4096
    assert PATCH_MIN_BYTES == 1 << 26
    assert not patch_route(torch.float32, g, g // 2, 1 << 20)
    assert patch_route(torch.float64, g, g // 2, 1 << 20)
    assert patch_route(torch.int32, g, g, 1 << 20)
    assert not patch_route(torch.int64, g, g, 1 << 20)
    assert patch_route(torch.float32, g, g, 256)
    assert not patch_route(torch.float32, g, g, 255)
    assert patch_route(torch.float64, g, g, 512)
    assert not patch_route(torch.float16, g, g, 1 << 20)
    assert not patch_route(torch.complex64, g, g, 1 << 20)
    assert not patch_route(torch.float32, 1 << 15, 1 << 14, 1 << 30)
    for dt in PATCH_TYPES:
        small = max(1, PATCH_MIN_BYTES // dt.itemsize)
        assert patch_route(dt, 1, small, 1 << 20)
        if PATCH_MIN_BYTES > dt.itemsize:
            assert not patch_route(dt, 1, small - 1, 1 << 20)
    n = 1 << 24
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64):
        assert cuda_gather.takes(dt, g * g, n)
        cuts = cuda_gather.INDEX_ROUTE[dt.itemsize]
        for least, per in cuts:
            m = least // dt.itemsize
            assert cuda_gather.index_route(dt, m, int(per * m))
            assert not cuda_gather.index_route(dt, m, int(per * m) - 1) \
                or any(m >= b // dt.itemsize and int(per * m) - 1 >= q * m
                       for b, q in cuts)
        small = min(b for b, _ in cuts) // dt.itemsize - 1
        assert not cuda_gather.index_route(dt, small, 16 * small)
        assert not cuda_gather.index_route(dt, 1 << 10, 1 << 10)
    # the bench's 4096^2 f32 table at 2^24 points, and 64 MB of f64
    assert cuda_gather.index_route(torch.float32, g * g, n)
    assert cuda_gather.index_route(torch.float64, g * g // 2, n)
    assert not cuda_gather.index_route(torch.float32, g * g, n // 8)
    assert cuda_gather.index_route(torch.float32, 2 * g * g, n // 2)
    for dt in (torch.float16, torch.uint8, torch.bool, torch.complex64):
        assert not cuda_gather.takes(dt, g * g, n)
        assert not cuda_gather.index_route(dt, g * g, n)
    assert not cuda_gather.takes(torch.float32, 1 << 31, n)
    assert not cuda_gather.takes(torch.float32, g * g, 0)


def test_forced_forms_raise_on_tables_they_do_not_take(tctx, monkeypatch):
    """A form forced on a table it does not take raises: the patch table
    on u16, complex and f16 images, the gather form's fused variant on an
    f16 table, on an output of another type than the sample's, on integer
    image coordinates and on keys of two types; a tree around the sample,
    and a key of three arrays, are no gather of two coordinates."""
    from vexcl_tpu_torch.expr import triton_emit
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.ops import image

    monkeypatch.setattr(image, "FORCE", "patch")
    for dt in (np.uint16, np.complex64, np.float16):
        im = vt.image2d(np.ones((3, 4), dt), filter="linear", context=tctx)
        with pytest.raises(NotImplementedError):
            im(vt.vector(data=np.zeros(4, np.float32), context=tctx),
               vt.vector(data=np.zeros(4, np.float32), context=tctx))
    x = vt.vector(data=np.zeros(8, np.float32), context=tctx)
    ix = vt.vector(data=np.zeros(8, np.int32), context=tctx)

    def operands(expr, out_dt=torch.float32):
        """(_index_gather_operands, the leaf of the tree's first child)."""
        e, an, ty, lv = prepare(expr, 8, tctx.device)
        slot = an.slot_of.get(id(e.children[0]))
        return (triton_emit._index_gather_operands(
            e, an, ty, lv, torch.empty(8, dtype=out_dt)),
            None if slot is None else lv[slot])

    monkeypatch.setattr(triton_emit, "INDEX_GATHER", "fused")
    for dt, out_dt in ((np.float16, torch.float16),
                       (np.float32, torch.float64)):
        im = vt.image2d(np.ones((3, 4), dt), filter="nearest",
                        context=tctx)
        with pytest.raises(NotImplementedError):
            operands(im(x, x), out_dt)
    im = vt.image2d(np.ones((3, 4), np.float32), filter="nearest",
                    context=tctx)
    lx = vt.vector(data=np.zeros(8, np.int64), context=tctx)
    tab = vt.vector(data=np.zeros(12, np.float32), context=tctx)
    for expr in (im(ix, ix), vt.slicer((3, 4))[ix, lx](tab)):
        with pytest.raises(NotImplementedError):
            operands(expr)
    (table, coords), want = operands(im(x, x))
    assert table is want and coords.a is x.storage and coords.b is x.storage
    assert coords.dims == (4, 3) and coords.strides == (1, 4)
    assert operands(im(x, x) + 1)[0] is None
    cube = vt.vector(data=np.zeros(24, np.float32), context=tctx)
    assert operands(vt.slicer((2, 3, 4))[ix, ix, ix](cube))[0] is None
    monkeypatch.setattr(triton_emit, "INDEX_GATHER", None)
    assert operands(im(x, x))[0] is None        # under the route's sizes


def test_patched_and_index_kernel_sources(tctx, monkeypatch):
    """The patched sample's kernel loads its table once, as rows of four
    (one 16-byte load a lane of f32), and keeps the signature apart
    (``:p``); V1's source of a nearest sample and of ``[i, j]`` alone
    (what the route leaves off the gather form) parses and loads the
    table once."""
    import ast

    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import assign_source
    from vexcl_tpu_torch.ops import image

    x = vt.vector(data=np.linspace(0, 3, 16, dtype=np.float32),
                  context=tctx)
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    sigs = []
    for form in ("patch", "taps"):
        monkeypatch.setattr(image, "FORCE", form)
        im = vt.image2d(img, filter="linear", context=tctx)
        e, an, ty, _ = prepare(im(x, x) * 2 + x, 16, tctx.device)
        src = assign_source(e, an, ty, "f32")
        ast.parse(src)
        loads = [ln for ln in src.splitlines() if "tl.load(p0 " in ln]
        assert len(loads) == (1 if form == "patch" else 4), src
        assert ("tl.arange(0, 4)" in loads[0]) == (form == "patch")
        sigs.append(an.sig)
    assert sigs[0] != sigs[1] and ":p" in sigs[0]
    near = vt.image2d(img, filter="nearest", context=tctx)
    i = vt.vector(data=np.arange(16, dtype=np.int32), context=tctx)
    for view in (near(x, x), vt.slicer((4, 4))[i, i](x)):
        e, an, ty, _ = prepare(view, 16, tctx.device)
        src = assign_source(e, an, ty, "f32")
        ast.parse(src)
        loads = [ln for ln in src.splitlines() if "tl.load(p0 " in ln]
        assert len(loads) == 1, src


def test_fused_coordinates_match_the_index_pass(ctx1, tctx):
    """The fused variant's operands (``triton_emit._fused_coords``) and
    the plain version of its index (``cuda_gather.coords_index``): equal
    to the index V1's plain form reads for nearest samples at f32 and f64
    coordinates (halves, huge, NaN) and for ``[i, j]`` with i32 and i64
    keys beyond either end; the table read there against the JAX
    package, bitwise; none for integer image coordinates, mixed key types
    or three arrays."""
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.node import EmitEnv
    from vexcl_tpu_torch.expr.triton_emit import _fused_coords
    from vexcl_tpu_torch.ops.cuda_gather import coords_index, gather_coords
    from vexcl_tpu_torch.ops.image import ImageSample

    def v1_index(e, an, ty, lv, n):
        """The flat index of V1's plain form."""
        env = EmitEnv({i: lv[s] for i, s in an.slot_of.items()}, ty, n,
                      tctx.device)
        if not isinstance(e, ImageSample):
            return e.plain_index(env)[0]
        coords = [e._coord(env, c) for c in e.children[1:]]
        return e._flat(e._nearest(coords), e.img.shape[::-1])

    rng = np.random.default_rng(35)
    img = rng.standard_normal((13, 9)).astype(np.float32)
    odd = [0.5, 1.5, 2.5, 12.5, -7.0, 3e9, -3e9, np.nan, np.inf, 8.5]
    xs = np.concatenate([rng.uniform(-3, 12, 100), odd])
    ys = np.concatenate([rng.uniform(-3, 16, 100), odd[::-1]])
    hx = rng.standard_normal(37 * 41).astype(np.float32)
    hi = np.array([0, 36, -1, -37, -38, 37, 90, 5, -200, 17])
    hj = np.array([40, 0, -41, -42, 41, 7, -1, 1000, 3, 2])
    cases = []
    for dt in (np.float32, np.float64):
        want = _sample(vex, ctx1, img, "nearest", (xs, ys), np.float32)
        X = vt.vector(data=xs.astype(dt), context=tctx)
        Y = vt.vector(data=ys.astype(dt), context=tctx)
        im = vt.image2d(img, filter="nearest", context=tctx)
        cases.append((im(X, Y), xs.size, want))
    x = vex.vector(data=hx, context=ctx1)
    y = vex.vector(hi.size, dtype=np.float32, context=ctx1)
    y[:] = vex.slicer((37, 41))[vex.vector(data=hi, context=ctx1),
                                vex.vector(data=hj, context=ctx1)](x)
    want = np.asarray(y)
    tx = vt.vector(data=hx, context=tctx)
    for kt in (np.int32, np.int64):
        i = vt.vector(data=hi.astype(kt), context=tctx)
        j = vt.vector(data=hj.astype(kt), context=tctx)
        cases.append((vt.slicer((37, 41))[i, j](tx), hi.size, want))
    for expr, n, want in cases:
        e, an, ty, lv = prepare(expr, n, tctx.device)
        table = lv[an.slot_of[id(e.children[0])]]
        out = torch.empty(n, dtype=torch.float32)
        c = _fused_coords(e, an, lv, out)
        assert c is not None
        np.testing.assert_array_equal(
            coords_index(c).numpy(),
            torch.broadcast_to(v1_index(e, an, ty, lv, n), (n,)).numpy())
        gather_coords(out, c, table)
        np.testing.assert_array_equal(out.numpy(), want)
    # integer image coordinates, mixed key types, three arrays: no fusion
    iv = vt.vector(data=np.arange(10, dtype=np.int32), context=tctx)
    lv64 = vt.vector(data=np.arange(10, dtype=np.int64), context=tctx)
    cube = vt.vector(data=np.zeros(5 * 37 * 41, np.float32), context=tctx)
    im = vt.image2d(img, filter="nearest", context=tctx)
    for expr in (im(iv, iv), vt.slicer((37, 41))[iv, lv64](tx),
                 vt.slicer((5, 37, 41))[iv, iv, iv](cube)):
        e, an, ty, lv = prepare(expr, 10, tctx.device)
        assert e.flat_coords() is None or _fused_coords(
            e, an, lv, torch.empty(10)) is None
