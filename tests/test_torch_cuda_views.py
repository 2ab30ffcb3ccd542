"""Views on the card against their plain versions on the CPU: V1 (indexed
loads, the tiled transpose), V2 (``reduce_view``, split), V3 (stores and
atomic updates through a view), aliasing, advanced slicer keys (V1, and
``[i, j]`` alone through the gather form's fused variant) and image
samples (nearest through V1 or the fused variant, linear through the
four taps or the patch table).

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_views.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.compile import prepare
from _cuda_common import (RTOL, gpu, cpu, _vec, _both, _close, _bitwise, _same,
                          _host_data, _on_both)

pytestmark = pytest.mark.cuda


# -- views: V1 (indexed loads), V2 (reduce_view), V3 (through a view) --------
#
# Each case runs the same API calls on the card (the kernels) and on the
# CPU (their plain versions) from the same host arrays.  Gathers, stores,
# MIN, MAX and integer results are bitwise; sums 1e-5 (f32, another
# order) and 1e-12 (f64) relative to the largest magnitude; float atomic
# adds and products 1e-5 (f32) and 1e-12 (f64): their order changes from
# run to run.

_SHAPES = {1: (1, 1), 1024: (32, 32), 1025: (25, 41),
           (1 << 24) + 3: (1549, 10831)}


@pytest.mark.parametrize("n", sorted(_SHAPES))
@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32,
                                torch.int64, torch.bfloat16])
def test_indexed_loads_match_plain(gpu, n, dt):
    """V1: every view kind and a nested one, out-of-range indices
    included, bitwise; one launch per assignment (of the gather form,
    ``ops/cuda_gather.py``, where its route takes the permutation)."""
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed
    from vexcl_tpu_torch.ops import cuda_gather

    big = n > (1 << 20)
    if big and dt not in (torch.float32, torch.int32):
        pytest.skip("the full size runs f32 and i32")
    L = n + 5
    rng = np.random.default_rng(n)
    x = _vec(gpu, _host_data(L, dt, 1))
    p = rng.integers(0, L, n)
    p[:: max(1, n // 7)] = -1
    if n > 2:
        p[1], p[2] = L + 3, -L - 2
    pv = _vec(gpu, p.astype(np.int32))
    a, b = _SHAPES[n]
    i = vex.element_index(0, n)
    exprs = [x[2:n + 2], vex.SliceTerminal(x, slice(n + 4, 4, -1)),
             vex.permutation(pv)(x), vex.raw_pointer(x)[(i * 7 + 3) % L],
             vex.reshape(x[0:n], (b, a), (1, 0)),
             vex.slicer((a, b))[:, :](vex.reshape(x[0:n], (a, b), (0, 1))),
             x[np.array([-1, L + 7, 3] * ((n + 2) // 3))[:n]],
             vex.permutation(pv % (L - 1))(x[1:L]) * 1]
    for e in exprs:
        _bitwise(*_both(e, n, dt, gpu.device))
    y = vex.vector(n, dtype=dt, context=gpu)
    before = assign_indexed.launches, cuda_gather.gather_ranges.launches
    y[:] = vex.permutation(pv)(x)
    torch.cuda.synchronize()
    routed = cuda_gather.route(dt, L, n, torch.int32)
    assert (assign_indexed.launches - before[0],
            cuda_gather.gather_ranges.launches - before[1]) == (
                (0, 1) if routed else (1, 0))


def test_one_compile_for_a_loop_over_indices(gpu):
    from vexcl_tpu_torch.cache import kernel_cache

    m = vex.multi_array(vex.extents[16][16][16], dtype=np.float32,
                        context=gpu)
    m.vec()[:] = 0
    m[vex.indices[0][vex._][vex._]].assign(0.0)
    y = vex.vector(256, dtype=np.float32, context=gpu)
    y[:] = y + m[vex.indices[0][vex._][vex._]]
    size = len(kernel_cache)
    for i in range(16):
        m[vex.indices[i][vex._][vex._]].assign(float(i))
        y[:] = y + m[vex.indices[i][vex._][vex._]]
    torch.cuda.synchronize()
    assert len(kernel_cache) == size
    idx = np.arange(16 ** 3).reshape(16, 16, 16)
    assert np.array_equal(m.to_numpy(), (idx // 256).astype(np.float32))
    assert np.array_equal(y.to_numpy(), np.full(256, 120.0, np.float32))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("shape", [(64, 48), (8, 12, 16)])
def test_reduce_view_matches_plain(gpu, cpu, dt, op, shape):
    """V2 over every axis set of a 2-D and a 3-D view, with a NaN for
    min and max."""
    import itertools

    n = int(np.prod(shape))
    rng = np.random.default_rng(len(shape))
    h = torch.from_numpy(rng.uniform(0.9, 1.1, n)).to(dt)
    if op in ("min", "max"):
        h[n // 3] = float("nan")
    tol = 0.0 if op in ("min", "max") else (
        1e-5 if dt == torch.float32 else 1e-12)
    nd = len(shape)
    for k in range(1, nd + 1):
        for axes in itertools.combinations(range(nd), k):
            res = []
            for c in (gpu, cpu):
                x = vex.vector(data=h, context=c)
                res.append(vex.eval(vex.reduce_view(
                    op, vex.slicer(shape)[(vex._,) * nd](x), axes)).cpu())
            torch.cuda.synchronize()
            if tol:
                _close(res[0], res[1], tol)
            else:
                _same(res[0], res[1])


def test_reduce_view_integer_and_multi_array(gpu, cpu):
    h = torch.from_numpy(np.random.default_rng(3).integers(
        -50, 50, 8 * 16 * 32)).to(torch.int32)
    for axes in ((0,), (2,), (1, 2)):
        res = []
        for c in (gpu, cpu):
            m = vex.multi_array((8, 16, 32), dtype=np.int32, context=c,
                                data=h.numpy())
            res.append(vex.eval(vex.reduce_view("sum", m, axes)).cpu())
        assert res[0].dtype == torch.int64
        _bitwise(res[0], res[1])


_SPLIT_SHAPES = [(4096, 33), (3, 5000), (20000, 1), (64, 512, 3)]


def _reduce_data(n, dt, seed, op):
    """Values for a reduction by ``op``; a product's factors are 1, 2 and
    -1 (integers) or 1/2 (floats), so that every order gives its exact
    value and the comparison is bitwise."""
    rng = np.random.default_rng(seed)
    if dt == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.9)
    if op == "prod":
        u = rng.random(n)
        other = 0.5 if dt.is_floating_point else -1
        return torch.from_numpy(np.where(u < 0.005, 2, np.where(
            u < 0.01, other, 1))).to(dt)
    if dt.is_floating_point:
        return torch.from_numpy(rng.uniform(0.9, 1.1, n)).to(dt)
    return torch.from_numpy(rng.integers(-3, 4, n)).to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32,
                                torch.bool])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max"])
@pytest.mark.parametrize("shape", _SPLIT_SHAPES)
def test_reduce_view_split_matches_plain(gpu, cpu, dt, op, shape):
    """V2 where the reduced range is split across programs: every axis
    set, a NaN in the reduced range's last chunk only (min, max), one
    launch a reduction, the same bits from two calls; against the plain
    version bitwise (min, max, products, integers) or, for float sums
    (another summation order), within 1e-5 / 1e-12 of the largest
    magnitude."""
    import itertools

    from vexcl_tpu_torch.ops.triton_reduce import _programs
    from vexcl_tpu_torch.ops.triton_reduce_view import (_layout, plan,
                                                        reduce_view_apply)

    n, nd = int(np.prod(shape)), len(shape)
    splits = 0
    for k in range(1, nd + 1):
        for axes in itertools.combinations(range(nd), k):
            h = _reduce_data(n, dt, 20 + len(axes), op)
            kc, _, rc, _, r_fast, _ = _layout(shape, axes)
            pl = plan(int(np.prod(kc)), int(np.prod(rc)), r_fast,
                      h.element_size(), _programs(gpu.device))
            splits += pl.nsplit > 1
            if dt.is_floating_point and op in ("min", "max"):
                # a NaN at the last reduced index of output 0's reduced
                # range: in the last chunk, and in no other
                idx = np.zeros(nd, dtype=np.int64)
                for a in axes:
                    idx[a] = shape[a] - 1
                h[int(np.ravel_multi_index(tuple(idx), shape))] = float("nan")
            res = []
            for c in (gpu, cpu):
                x = vex.vector(data=h, context=c)
                node = vex.reduce_view(op, vex.slicer(shape)[(vex._,) * nd](x),
                                       axes)
                before = reduce_view_apply.launches
                res.append(vex.eval(node))
                if c is gpu:
                    again = vex.eval(node)
                    torch.cuda.synchronize()
                    assert reduce_view_apply.launches == before + 2
                    _bitwise(res[0], again)
            k_, p_ = res[0].cpu(), res[1]
            if dt.is_floating_point and op == "sum":
                _close(k_, p_, 1e-5 if dt == torch.float32 else 1e-12)
            elif dt.is_floating_point and op in ("min", "max"):
                _same(k_, p_)
                assert torch.isnan(k_[0])
            else:
                _bitwise(k_, p_)
    assert splits > 0


def _view_data(n, dt, seed):
    if dt == torch.bool:
        return _host_data(n, torch.int32, seed) % 2 != 0
    return _host_data(n, dt, seed)


def _transpose_cases(dt):
    """(name, function of (x, y) vectors writing into a new vector of n
    elements, n, the length of x and y, whether the tiled form is
    taken) for the tiled assignment kernel."""
    a, b = 1000, 777
    c3 = (37, 45, 29)
    n3 = int(np.prod(c3))
    combine = (lambda u, v: u != v) if dt == torch.bool else (
        lambda u, v: u + v)
    return [
        ("2d", lambda x, y: vex.reshape(x, (a, b), (1, 0)), a * b, a * b,
         True),
        ("3d_201", lambda x, y: vex.reshape(x, c3, (2, 0, 1)), n3, n3, True),
        ("3d_021", lambda x, y: vex.reshape(x, c3, (0, 2, 1)), n3, n3, True),
        ("leaf_plus_plain", lambda x, y: combine(
            vex.reshape(x, (a, b), (1, 0)), y), a * b, a * b, True),
        ("under_slicer", lambda x, y: vex.slicer((b, a))[vex.r(1, b - 1), :](
            vex.reshape(x, (b, a), (1, 0))), (b - 2) * a, a * b, False),
        ("of_a_slicer", lambda x, y: vex.reshape(
            vex.slicer((a, b))[:, :](x), (b, a), (1, 0)), a * b, a * b,
         True),
        ("broadcast", lambda x, y: vex.reshape(x[0:a], (a, b), (0,)), a * b,
         a * b, True),
    ]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int8,
                                torch.bool])
def test_tiled_transpose_matches_plain(gpu, cpu, dt):
    """V1's tiled form (a view read with coefficient 1 on an axis before
    the innermost): 2-D and 3-D transposes at sizes that are no tile
    multiples, beside a plain leaf, under and over a slicer, a broadcast
    reshape, bitwise against the plain version, one launch each; and a
    target read under its own transpose."""
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed, tiled_view

    for name, fn, n, m, tiled in _transpose_cases(dt):
        hx, hy = _view_data(m, dt, 30), _view_data(m, dt, 31)
        res = []
        for c in (gpu, cpu):
            x, y = vex.vector(data=hx, context=c), vex.vector(data=hy,
                                                              context=c)
            out = vex.vector(n, dtype=dt, context=c)
            expr = fn(x, y)
            before = assign_indexed.launches
            out[:] = expr
            if c is gpu:
                torch.cuda.synchronize()
                assert assign_indexed.launches == before + 1, name
                e, an, _, _ = prepare(expr, n, gpu.device)
                assert (tiled_view([e]) is not None) == tiled, name
            res.append(out.storage.cpu())
        _bitwise(res[0], res[1])
    # a target read under its own transpose goes through a temporary
    s = 300
    hx = _view_data(s * s, dt, 32)
    k, pl = _on_both(gpu, cpu, lambda x: x.assign(
        vex.reshape(x, (s, s), (1, 0))), hx)
    _bitwise(k[0], pl[0])
    _bitwise(k[0], hx.view(s, s).t().reshape(-1))


@pytest.mark.parametrize("op", ["=", "+=", "-=", "*=", "/="])
@pytest.mark.parametrize("dt", [torch.float32, torch.int32])
def test_assign_through_views_matches_plain(gpu, cpu, op, dt):
    """V3: static slice and gslice targets (unique indices, compound ops
    read-modify-write) and a permutation with unique indices."""
    if op == "/=" and not dt.is_floating_point:
        pytest.skip("integer /= makes a float and casts back: covered by f32")
    n = 64 * 48
    hx = (_host_data(n, dt, 4) % 7 + 8).to(dt)
    hv = (_host_data(n, dt, 5) % 5 + 1).to(dt)
    hp = torch.from_numpy(np.random.default_rng(6).permutation(n)[:1000]
                          .astype(np.int32))

    def run(x, v, p):
        x[3:n:3].assign(v[0:(n - 3 + 2) // 3] * 2, op)
        vex.slicer((64, 48))[:, 5](x).assign(v[100:164], op)
        vex.permutation(p)(x).assign(v[0:1000] + 1, op)
    k, pl = _on_both(gpu, cpu, run, hx, hv, hp)
    if dt.is_floating_point:
        _close(k[0], pl[0], 1e-6)
    else:
        _bitwise(k[0], pl[0])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32,
                                torch.int64])
def test_atomic_updates_match_plain(gpu, cpu, dt):
    """Each atomic combine with repeated indices, ``+=`` and ``*=``
    through a permutation, and out-of-range indices dropped."""
    n, bins = 1 << 16, 97
    rng = np.random.default_rng(7)
    hk = torch.from_numpy(rng.integers(-3, bins + 3, n).astype(np.int32))
    hv = _host_data(n, dt, 8)
    hy = _host_data(bins, dt, 9)
    hm = torch.from_numpy(rng.integers(0, bins, 200).astype(np.int32))
    hw = (torch.from_numpy(rng.integers(1, 3, 200)).to(dt))
    for kind in ("add", "sub", "min", "max"):
        def run(y, k, v, m, w):
            vex.eval(getattr(vex, f"atomic_{kind}")(vex.permutation(k)(y),
                                                    v))
            vex.eval(vex.atomic_add(vex.permutation(k)(y), 1))
        res = _on_both(gpu, cpu, run, hy, hk, hv, hm, hw)
        if dt.is_floating_point and kind in ("add", "sub"):
            _close(res[0][0], res[1][0], 1e-5 if dt == torch.float32
                   else 1e-12)
        else:
            _bitwise(res[0][0], res[1][0])

    def run2(y, k, v, m, w):
        vex.permutation(m)(y).assign(w, "*=")
        vex.permutation(k)(y).assign(v, "+=")
    res = _on_both(gpu, cpu, run2, hy % 5 + 1, hk, hv, hm, hw)
    if dt.is_floating_point:
        _close(res[0][0], res[1][0], 1e-5 if dt == torch.float32 else 1e-12)
    else:
        _bitwise(res[0][0], res[1][0])


def test_view_aliasing_on_the_card(gpu, cpu):
    """A target read through a view reads its old values."""
    n = 256
    hx = _host_data(n * n, torch.float32, 10)
    hp = torch.from_numpy(np.random.default_rng(11).permutation(n * n)
                          .astype(np.int32))
    cases = [
        lambda x, p: x.assign(vex.permutation(p)(x)),
        lambda x, p: x.__setitem__(slice(1, None), x[:-1]),
        lambda x, p: x.assign(vex.reshape(x, (n, n), (1, 0))),
        lambda x, p: x.assign(x + vex.permutation(p)(x), "+="),
        lambda x, p: vex.slicer((n, n))[:, 3](x).assign(
            vex.slicer((n, n))[3](x)),
        lambda x, p: x.__setitem__(slice(0, n), vex.reduce_view(
            "sum", vex.slicer((n, n))[:, :](x), 1)),
        lambda x, p: vex.tie(x, vex.vector(n * n, context=x.context))
        .assign((vex.reshape(x, (n, n), (1, 0)), x)),
    ]
    for case in cases:
        k, pl = _on_both(gpu, cpu, case, hx, hp)
        _close(k[0], pl[0], 1e-5)


# -- advanced slicer keys and image samples: V1, the gather form's fused
# variant (csrc/gather.cu), and the patch table ----------------------------

def _launch_counts():
    """(V1 launches, V1 complex launches, gather calls, fused gather
    calls)."""
    from vexcl_tpu_torch.expr.triton_emit import (assign_complex,
                                                  assign_indexed)
    from vexcl_tpu_torch.ops.cuda_gather import gather_coords, gather_ranges

    torch.cuda.synchronize()
    return (assign_indexed.launches, assign_complex.launches,
            gather_ranges.launches, gather_coords.launches)


def _launched(before):
    """What ran since ``_launch_counts()`` gave ``before``: "v1" (one V1
    launch), "fused" (one call of the fused variant), or the counts."""
    d = tuple(a - b for a, b in zip(_launch_counts(), before))
    return {(1, 0, 0, 0): "v1", (0, 1, 0, 0): "v1",
            (0, 0, 0, 1): "fused"}.get(d, d)


def test_advanced_slicer_keys_kernel_matches_plain(gpu, cpu, monkeypatch):
    """Index arrays beside integers, two arrays adjacent and separated by
    a slice (their axis first), an array of one element broadcast, with
    out-of-range indices (wrapped, then clamped): inside a tree V1's
    indexed loads, one launch each; a key of two index arrays and integers
    on every dimension (``flat_coords``) assigned on its own, forced
    through V1 and through the fused variant; each bitwise against the
    plain version."""
    from vexcl_tpu_torch.expr import triton_emit

    dims = (37, 41, 29)
    hx = torch.from_numpy(np.random.default_rng(43).standard_normal(
        int(np.prod(dims))).astype(np.float32))
    hi = np.array([0, 36, -1, 40, -40, 5, 17, 3, 8, 2, 1])
    hj = np.array([28, 0, 13, -3, 41, 7, 6, 5, 4, 3, 2])
    cases = [lambda i, j, o: (i, 5), lambda i, j, o: (3, i),
             lambda i, j, o: (i, j), lambda i, j, o: (i, vex._, j),
             lambda i, j, o: (vex._, i, j), lambda i, j, o: (i, vex._, o),
             lambda i, j, o: (2, vex._, i), lambda i, j, o: (i, 1, j),
             lambda i, j, o: (o, i), lambda i, j, o: (vex.r(1, 30), i, 4),
             lambda i, j, o: (i, j, 3), lambda i, j, o: (o, i, j),
             lambda i, j, o: (2, 7, i)]
    alone = 0
    for key in cases:
        forms = [("tree", None)]
        res = {}
        for c in (gpu, cpu):
            x = vex.vector(data=hx, context=c)
            i, j, o = (vex.vector(data=a, context=c)
                       for a in (hi, hj, np.array([4])))
            view = vex.slicer(dims)[key(i, j, o)](x)
            if c is gpu and view.flat_coords() is not None:
                forms += [("v1", "v1"), ("fused", "fused")]
            for form, force in forms:
                monkeypatch.setattr(triton_emit, "INDEX_GATHER", force)
                out = vex.vector(view.size_hint(), dtype=torch.float32,
                                 context=c)
                before = _launch_counts() if c is gpu else None
                if form == "tree":
                    out[:] = view * 2 + 1
                else:
                    out[:] = view
                if c is gpu:
                    assert _launched(before) == ("v1" if form == "tree"
                                                 else form), form
                    res[form] = out.storage.cpu()
                else:
                    res["plain_" + ("tree" if form == "tree"
                                    else "alone")] = out.storage.cpu()
                if c is cpu and form != "tree":
                    break
        _bitwise(res["tree"], res["plain_tree"])
        for form in ("v1", "fused"):
            if form in res:
                alone += 1
                _bitwise(res[form], res["plain_alone"])
    # (i, 1, j), (i, j, 3), (o, i, j) and (2, 7, i) key every dimension,
    # the first two with two arrays
    assert alone == 2 * 2


def _image_forms(filt, ndim, alone):
    """(form, forced value) of the image's forms: the four taps and the
    patch table for a linear 2-D sample, V1 and the fused variant for a
    nearest 2-D sample alone, V1 otherwise."""
    if filt == "linear" and ndim == 2:
        return [("taps", "taps"), ("patch", "patch")]
    if filt == "nearest" and ndim == 2 and alone:
        return [("v1", "v1"), ("fused", "fused")]
    return [("v1", None)]


def _force(monkeypatch, filt, value):
    from vexcl_tpu_torch.expr import triton_emit
    from vexcl_tpu_torch.ops import image

    if filt == "linear":
        monkeypatch.setattr(image, "FORCE", value)
        monkeypatch.setattr(triton_emit, "INDEX_GATHER", None)
    else:
        monkeypatch.setattr(image, "FORCE", None)
        monkeypatch.setattr(triton_emit, "INDEX_GATHER", value)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_image_sampling_kernel_matches_plain(gpu, dt, monkeypatch):
    """image1d and image2d, nearest (bitwise) and linear (4 RTOL: the
    kernel contracts products into FMAs), at the edges, at halves and
    outside the image, each form forced: a linear 2-D sample through the
    four taps and through the patch table (one V1 launch each), a nearest
    2-D sample alone through V1 and through the fused variant (one call,
    no V1 launch); inside a tree one V1 launch."""
    rng = np.random.default_rng(44)
    h, w, n = 61, 47, 30000
    img = rng.standard_normal((h, w))
    xs = rng.uniform(-3, w + 3, n)
    ys = rng.uniform(-3, h + 3, n)
    edge = [0.0, w - 1.0, -0.5, w - 0.5, 2.5, 3.5, -3.0, w + 2.0, np.nan,
            3e9]
    xs[:len(edge)], ys[:len(edge)] = edge, edge[::-1]
    npdt = np.float32 if dt == torch.float32 else np.float64
    X = vex.vector(data=xs.astype(npdt), context=gpu)
    Y = vex.vector(data=ys.astype(npdt), context=gpu)
    seen = set()
    trees = [(2, True, lambda i2, i1: i2(X, Y)),
             (1, True, lambda i2, i1: i1(X)),
             (2, False, lambda i2, i1: 2 * i2(X, Y) + i1(Y))]
    for f in ("nearest", "linear"):
        for ndim, alone, build in trees:
            for form, value in _image_forms(f, ndim, alone):
                _force(monkeypatch, f, value)
                im2 = vex.image2d(img.astype(npdt), filter=f, context=gpu)
                im1 = vex.image1d(img[3].astype(npdt), filter=f,
                                  context=gpu)
                expr = build(im2, im1)
                before = _launch_counts()
                k, p = _both(expr, n, dt, gpu.device)
                assert _launched(before) == (
                    form if form == "fused" else "v1"), (f, form)
                seen.add(form)
                if f == "nearest":
                    _bitwise(k, p)
                else:
                    _close(k, p, 4 * RTOL[dt])
    assert seen == {"v1", "fused", "taps", "patch"}


@pytest.mark.parametrize("table", ["i32", "b1", "u16", "c64", "f16_coords",
                                   "i32_coords"])
def test_image_sample_types_kernel_matches_plain(gpu, table, monkeypatch):
    """Integer, boolean, unsigned and complex tables with f32
    coordinates, and an f32 table at f16 and i32 coordinates: nearest and
    linear samples inside and outside the image, bitwise (integers and
    nearest samples) or within 4 RTOL (f32 and c64 lerps); one V1 launch
    a sample (counted on ``assign_complex`` for the complex table).  Each
    form the table takes is forced: the patch table for 4- and 8-byte
    real tables, the fused variant for nearest 2-D samples of tables
    ``cuda_gather`` takes at float coordinates; on the others the forced
    form raises."""
    rng = np.random.default_rng(45)
    h, w, n = 19, 23, 20000
    img = rng.standard_normal((h, w)) * 50
    xs, ys = rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)
    npdt, cdt = {"i32": (np.int32, np.float32), "b1": (np.bool_, np.float32),
                 "u16": (np.uint16, np.float32),
                 "c64": (np.complex64, np.float32),
                 "f16_coords": (np.float32, np.float16),
                 "i32_coords": (np.float32, np.int32)}[table]
    if npdt == np.bool_:
        img = img > 0
    elif npdt == np.uint16:
        img = np.abs(img)
    elif npdt == np.complex64:
        img = img + 1j * rng.standard_normal((h, w))
    X = vex.vector(data=xs.astype(cdt), context=gpu)
    Y = vex.vector(data=ys.astype(cdt), context=gpu)
    takes = npdt in (np.int32, np.float32)
    for f in ("nearest", "linear"):
        for ndim in (2, 1):
            for form, value in _image_forms(f, ndim, True):
                _force(monkeypatch, f, value)
                if form in ("patch", "fused") and not takes or (
                        form == "fused" and cdt != np.float32):
                    im2 = vex.image2d(img.astype(npdt), filter=f,
                                      context=gpu)
                    with pytest.raises(NotImplementedError):
                        e = im2(X, Y)
                        vex.eval(e)
                    continue
                im2 = vex.image2d(img.astype(npdt), filter=f, context=gpu)
                im1 = vex.image1d(img[2].astype(npdt), filter=f,
                                  context=gpu)
                expr = im2(X, Y) if ndim == 2 else im1(X)
                res = vex.eval(expr).dtype
                before = _launch_counts()
                k, p = _both(expr, n, res, gpu.device)
                assert _launched(before) == (
                    form if form == "fused" else "v1"), (f, form)
                if f == "nearest" or not (res.is_floating_point
                                          or res.is_complex):
                    _bitwise(k, p)
                elif res.is_complex:
                    _close(torch.view_as_real(k).reshape(-1),
                           torch.view_as_real(p).reshape(-1), 4 * RTOL[
                               torch.float32])
                else:
                    _close(k, p, 4 * RTOL[torch.float32])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32])
@pytest.mark.parametrize("shape", [(1, 1), (1, 4097), (4097, 1), (61, 47),
                                   (1024, 1024)])
def test_patch_table_on_the_card(gpu, dt, shape):
    """The patch table built on the card (tensor copies) against its build
    on the CPU, bitwise, and rebuilt in place after a write into the
    image's tensor."""
    from vexcl_tpu_torch.ops.image import patch_table

    host = torch.from_numpy((np.random.default_rng(46).standard_normal(
        shape) * 100).astype(np.float64)).to(dt)
    data = host.to(gpu.device)
    im = vex.image2d(data, filter="linear", context=gpu)
    table = im.patch()
    assert table.device == data.device
    _bitwise(table, patch_table(host).to(gpu.device))
    data[-1, -1] = 7
    host[-1, -1] = 7
    assert im.patch() is table
    _bitwise(table, patch_table(host).to(gpu.device))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_patched_sample_sees_the_ports_own_writes(gpu, dt, monkeypatch):
    """An image over a vector's storage, the patch table forced: each of
    the port's own kernels that writes the vector in place (an
    assignment, V3's store through a slice, the CUDA scan into its
    source) moves the tensor's ``_version``, and the next sample, through
    an assignment and through a recorded generator kernel, reads the new
    texels: within 4 RTOL of the four taps of a copy of the image."""
    from vexcl_tpu_torch.ops import image

    monkeypatch.setattr(image, "FORCE", "patch")
    rng = np.random.default_rng(48)
    h, w, n = 37, 54, 5000
    npdt = np.float32 if dt == torch.float32 else np.float64
    v = vex.vector(data=rng.random(h * w).astype(npdt), context=gpu)
    im = vex.image2d(v.storage.view(h, w), filter="linear", context=gpu)
    X = vex.vector(data=rng.uniform(-2, w + 2, n).astype(npdt), context=gpu)
    Y = vex.vector(data=rng.uniform(-2, h + 2, n).astype(npdt), context=gpu)
    out = vex.vector(n, dtype=dt, context=gpu)
    sample = im(X, Y)
    assert sample.patched
    gen = vex.generator
    a, b, o = gen.symbolic(), gen.symbolic(), gen.symbolic()
    o.assign(im(a, b))
    kernel = gen.build_kernel("sample", [o], [o, a, b])
    kernel(out, X, Y)

    def taps():
        monkeypatch.setattr(image, "FORCE", "taps")
        ref = vex.image2d(v.storage.clone().view(h, w), filter="linear",
                          context=gpu)
        r = vex.vector(n, dtype=dt, context=gpu)
        r[:] = ref(X, Y)
        monkeypatch.setattr(image, "FORCE", "patch")
        return r.storage

    hw = h * w
    writes = [lambda: v.assign(v * 2 + 1),
              lambda: v[0:hw:2].assign(v[1:hw:2] * 0.5 - 3),
              lambda: vex.inclusive_scan(v, v)]
    for write in writes:
        version = v.storage._version
        write()
        assert v.storage._version > version
        assert im.data.data_ptr() == v.storage.data_ptr()
        want = taps()
        out[:] = sample
        _close(out.storage, want, 4 * RTOL[dt])
        out[:] = 0
        kernel(out, X, Y)
        _close(out.storage, want, 4 * RTOL[dt])
    assert all(r is not None for r in kernel._bindings.values())


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_patched_sample_reads_a_row_in_16_byte_loads(gpu, dt, monkeypatch):
    """The patched sample's compiled kernel (Triton's PTX) reads the table
    row of a lane in 16-byte loads: one ``ld.global.v4.b32`` (f32) or two
    ``ld.global.v2.b64`` (f64) for its four texels."""
    import re

    from vexcl_tpu_torch.expr.triton_emit import (_AssignKernel,
                                                  assign_source,
                                                  launch_args, launch_shape,
                                                  tensor_arg)
    from vexcl_tpu_torch.ops import image
    from vexcl_tpu_torch.types import code_of

    monkeypatch.setattr(image, "FORCE", "patch")
    n = 4096
    npdt = np.float32 if dt == torch.float32 else np.float64
    im = vex.image2d(np.random.default_rng(47).random((64, 64)).astype(npdt),
                     filter="linear", context=gpu)
    X = vex.vector(data=np.linspace(0, 63, n).astype(npdt), context=gpu)
    e, an, ty, lv = prepare(im(X, X), n, gpu.device)
    k = _AssignKernel(assign_source(e, an, ty, code_of(dt)),
                      shape=launch_shape([e]))
    out = torch.empty(n, dtype=dt, device=gpu.device)
    compiled = k.launcher.jit_launch(
        (-(-n // k.consts[0]),), [tensor_arg(out), *launch_args(lv)], (n,),
        k.consts, gpu.device)
    ptx = compiled.asm["ptx"]
    wide = re.findall(r"ld\.global[\w.:]*?\.v(\d)\.b(\d+)", ptx)
    want = [("4", "32")] if dt == torch.float32 else [("2", "64")] * 2
    assert sorted(wide) == sorted(want), wide
