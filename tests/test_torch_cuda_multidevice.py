"""Contexts of several parts on the card: the halo'd form of the DIA
kernel against its plain version, and each per-part path against the
one-part result.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_multidevice.py

Four parts share the one card (``Context(devices=[dev] * 4)``); where the
host has several cards, ``test_parts_over_distinct_cards`` spreads them
over the cards.  Bit for bit: expressions, the counter-based generators,
the DIA and CSR products and the stencils (each output is summed in the
one-part order), MAX/MIN scans and add scans of integer-valued data
(exact sums); f32 add scans on other data and sums of the Reductor
within 1e-5 of the largest magnitude (another association).  Each
per-part call launches its kernel once a part, the stencil twice (the
block, then one launch over its boundary windows where a neighbour
lies within the halo), the scan once a part
and once over the parts' tails, with one carry pass of the assignment
kernel a part after the first.  Sort, the FFT, the keyed scans,
reduce_by_key and any_of/all_of over parts: the sort bit
for bit one part's (six merges over four parts); the four-step FFT within
2e-5 (c64) and 1e-12 (c128) of the one-part cuFFT transform relative to
its largest magnitude, with two cuFFT executions and the tiled transposes
a part, and the gathered route, one execution, where the geometry does
not decompose; the keyed scans and reduce_by_key bit for bit for MAX, MIN
and integer-valued sums, f32 sums within 1e-5, with one keyed-kernel
launch a part.  Other tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.triton_emit import assign
from vexcl_tpu_torch.models import PoissonSolver
from vexcl_tpu_torch.expr.triton_emit import assign_complex
from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_launch,
                                             scan_by_key_apply)
from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply
from vexcl_tpu_torch.ops.cufft import execute as cufft_execute
from vexcl_tpu_torch.ops.sort_dist import sort_parts
from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply
from vexcl_tpu_torch.ops.triton_reduce import map_reduce
from vexcl_tpu_torch.sparse.cuda_dia import (dia_matvec, dia_matvec_halo,
                                             dia_matvec_halo_plain)
from vexcl_tpu_torch.sparse.cuda_sell import csr_spmv
from vexcl_tpu_torch.sparse.distributed import distributed
from vexcl_tpu_torch.utils.poisson import poisson_7pt
from _cuda_common import RTOL, _bitwise, _close, gpu

pytestmark = pytest.mark.cuda

PARTS = 4


@pytest.fixture(scope="module")
def parts(gpu):
    return vex.Context(devices=[gpu.device] * PARTS, set_current=False)


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float32),
                                  (torch.float32, torch.float32),
                                  (torch.float64, torch.float64)])
@pytest.mark.parametrize("offs", [(-1, 0, 1), (-4096, -64, -1, 0, 1, 64, 4096),
                                  (3, 7)])
@pytest.mark.parametrize("rows", [(0, 40000), (40000, 90000),
                                  (90000, 1 << 17), (5, 6)])
def test_dia_halo_kernel_matches_plain(gpu, pair, offs, rows):
    """The rows [r0, r1) of a 2^17-row matrix, x read from the part's
    block and its halos: bitwise against the halo'd plain version and
    against those rows of the one-part kernel; NaN in the plane entries
    outside the matrix, which must never be read."""
    n = 1 << 17
    r0, r1 = rows
    vdt, xdt = pair
    g = torch.Generator().manual_seed(r0 + len(offs))
    vals = torch.randn((len(offs), n), generator=g).to(vdt)
    x = torch.randn(n, generator=g).to(xdt)
    i = torch.arange(n)
    for k, o in enumerate(offs):
        vals[k, (i + o < 0) | (i + o >= n)] = float("nan")
    vals, x = vals.to(gpu.device), x.to(gpu.device)
    offd = torch.tensor(offs, dtype=torch.int64, device=gpu.device)
    lh, rh = max(0, -min(offs)), max(0, max(offs))
    xl, xr = _window(x, r0 - lh, r0), _window(x, r1, r1 + rh)
    pv = vals[:, r0:r1].contiguous()
    xb = x[r0:r1].contiguous()
    before = dia_matvec_halo.launches
    k = dia_matvec_halo(r0, n, offs, offd, pv, xl, xb, xr)
    assert dia_matvec_halo.launches == before + 1
    p = dia_matvec_halo_plain(r0, n, offs, pv, xl, xb, xr)
    whole = dia_matvec(n, n, offs, offd, vals, x)[r0:r1]
    torch.cuda.synchronize()
    assert not torch.isnan(k).any()
    _bitwise(k, whole)
    _close(k, p, 4 * RTOL[xdt])
    out = torch.empty_like(k)
    dia_matvec_halo(r0, n, offs, offd, pv, xl, xb, xr, out)
    _bitwise(out, k)


def _window(x, lo, hi):
    """x at [lo, hi), edge-replicated beyond its ends."""
    idx = torch.arange(lo, hi, device=x.device).clamp_(0, x.shape[0] - 1)
    return x[idx].contiguous()


def test_dia_halo_kernel_refuses_short_halos(gpu):
    offs = (-64, 0, 64)
    x = torch.ones(1000, device=gpu.device)
    vals = torch.ones((3, 500), device=gpu.device)
    offd = torch.tensor(offs, dtype=torch.int64, device=gpu.device)
    with pytest.raises(ValueError):
        dia_matvec_halo(200, 1000, offs, offd, vals, x[:10], x[:500],
                        x[:64])


def _launches(counter, fn):
    before = counter.launches
    fn()
    torch.cuda.synchronize()
    return counter.launches - before


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_expressions_and_rng_over_parts_bitwise(gpu, parts, dt):
    n = (1 << 20) + 3
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal(n) for _ in range(2))
    got = []
    for c in (gpu, parts):
        x, y = (vex.vector(data=t, context=c, dtype=dt) for t in (a, b))
        z = vex.vector(n, dtype=dt, context=c)

        def run():
            z[:] = 2 * x + vex.sin(y) * vex.element_index()
        k = _launches(assign, run)
        assert k == c.size
        r = vex.vector(n, dtype=dt, context=c)
        k = _launches(assign, lambda: r.assign(
            vex.Random(dt, "philox")(vex.element_index(), 42)))
        assert k == c.size
        vex.tie(x, y)[:] = (y + z, x * 2)
        got.append([t.to_numpy() for t in (z, r, x, y)])
    for g1, g4 in zip(*got):
        np.testing.assert_array_equal(g4.view(np.uint8), g1.view(np.uint8))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_reductor_over_parts(gpu, parts, dt):
    n = (1 << 22) + 11
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    a[n - 5] = np.nan
    out = {}
    for c in (gpu, parts):
        x, y = (vex.vector(data=t, context=c, dtype=dt) for t in (a, b))
        out[c.size] = {kind: vex.Reductor(getattr(vex, kind))(x * y)
                       for kind in ("MIN", "MAX")}
        x[n - 5] = 0.0
        k = _launches(map_reduce, lambda: out[c.size].update(
            SUM=vex.Reductor(vex.SUM)(x * y)))
        assert k == c.size
        out[c.size]["MIN_MAX"] = vex.Reductor(vex.MIN_MAX)(x)
    one, many = out[1], out[PARTS]
    assert np.isnan(many["MIN"]) and np.isnan(many["MAX"])
    assert many["MIN_MAX"] == one["MIN_MAX"]
    assert abs(many["SUM"] - one["SUM"]) <= (
        1e-5 if dt == torch.float32 else 1e-10) * max(1, abs(one["SUM"]))


def test_cg_over_parts(gpu, parts):
    """PoissonSolver(64) in f32 over 4 parts (DIA with halos, per-part
    expressions and Reductor dots) against the one-part solve."""
    f = (np.random.default_rng(5).random(64 ** 3) - 0.5).astype(np.float32)
    got = {}
    for c in (gpu, parts):
        solver = PoissonSolver(64, context=c)
        if c is parts:
            assert solver.A.device.mode == "dia_halo"
            k = _launches(dia_matvec_halo, lambda: got.update(
                {c.size: solver.solve(f, maxiter=50)}))
            assert k == (got[c.size][1] + 1) * PARTS
        else:
            got[c.size] = solver.solve(f, maxiter=50)
    (x1, i1), (x4, i4) = got[1], got[PARTS]
    assert abs(i1 - i4) <= 1
    _close(torch.from_numpy(x4.to_numpy()), torch.from_numpy(x1.to_numpy()),
           1e-3)


@pytest.mark.parametrize("shape", [(1 << 22, 5, 2), (1 << 20, 255, 100),
                                   (1 << 12, 255, 254), (600, 255, 3)])
def test_stencil_over_parts_bitwise(gpu, parts, shape):
    """Each part's block and its boundary fix-up against the one-part
    kernel, bit for bit; parts shorter than the halo (600 elements, 255
    taps) take one launch over their window."""
    n, width, center = shape
    rng = np.random.default_rng(width)
    a = rng.standard_normal(n).astype(np.float32)
    st = vex.stencil(rng.standard_normal(width).astype(np.float32), center)
    res = []
    for c in (gpu, parts):
        x = vex.vector(data=a, context=c)
        y = vex.vector(n, dtype=torch.float32, context=c)
        k = _launches(stencil_apply, lambda: y.assign(x * st))
        if c is parts:      # the block, and the fix-up where a neighbour
            assert PARTS <= k <= 2 * PARTS      # is within the halo
        res.append(y.to_numpy())
    np.testing.assert_array_equal(res[1].view(np.uint32),
                                  res[0].view(np.uint32))


def test_dia_spmv_over_parts_bitwise(gpu, parts):
    ptr, col, val = poisson_7pt(64, dtype=np.float32)
    n = 64 ** 3
    a = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    res = []
    for c in (gpu, parts):
        A = vex.SpMat(n, n, ptr, col, val, context=c)
        x = vex.vector(data=a, context=c)
        y = vex.vector(n, dtype=torch.float32, context=c)
        counter = dia_matvec if c is gpu else dia_matvec_halo
        assert _launches(counter, lambda: y.assign(A * x)) == c.size
        res.append(y.to_numpy())
    np.testing.assert_array_equal(res[1].view(np.uint32),
                                  res[0].view(np.uint32))


def _lognormal(n, seed):
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, rng.lognormal(np.log(16) - 0.32, 0.8, n)
                      .astype(np.int64))
    lens[::97] = 1500                               # rows of a block alone
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, n, int(ptr[-1])).astype(np.int32)
    return ptr, col, rng.standard_normal(int(ptr[-1])).astype(np.float32)


@pytest.mark.parametrize("mode", ["ell_a2a", "ell_allgather"])
def test_csr_over_parts_bitwise(gpu, parts, mode):
    """The CSR kernel on each part over the row blocks of the whole
    matrix (entries at their positions modulo 4), bit for bit the one-part
    product; ghost sets and the gathered x."""
    n = 1 << 17
    ptr, col, val = _lognormal(n, 9)
    a = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    A1 = vex.SpMat(n, n, ptr, col, val, context=gpu)
    assert A1.device.format == "csr"
    x1 = vex.vector(data=a, context=gpu)
    y1 = vex.vector(n, dtype=torch.float32, context=gpu)
    y1[:] = A1 * x1
    Ad = distributed(n, n, ptr, col, val, context=parts, mode=mode)
    x = vex.vector(data=a, context=parts)
    y = vex.vector(n, dtype=torch.float32, context=parts)
    assert _launches(csr_spmv, lambda: y.assign(Ad * x)) == PARTS
    np.testing.assert_array_equal(y.to_numpy().view(np.uint32),
                                  y1.to_numpy().view(np.uint32))


@pytest.mark.parametrize("op", ["add", "add_integers", "max", "min"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_over_parts(gpu, parts, op, exclusive):
    n = (1 << 22) + 5
    rng = np.random.default_rng(8)
    a = (rng.integers(0, 2, n) if op == "add_integers"
         else rng.standard_normal(n)).astype(np.float32)
    top = {"max": torch.maximum, "min": torch.minimum}.get(op)
    fn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    init = 0.5 if exclusive else None
    res = []
    for c in (gpu, parts):
        x = vex.vector(data=a, context=c)
        k = _launches(scan_apply, lambda: res.append(
            fn(x, init=init, op=top).to_numpy()))
        assert k == (c.size + 1 if c is parts else 1)
    if op == "add":
        _close(torch.from_numpy(res[1]), torch.from_numpy(res[0]), 1e-5)
    else:
        np.testing.assert_array_equal(res[1].view(np.uint32),
                                      res[0].view(np.uint32))


@pytest.mark.parametrize("case", ["nan_ties", "descending", "key_fn"])
def test_sort_over_parts_bitwise(gpu, parts, case):
    n = (1 << 20) + 3
    rng = np.random.default_rng(11)
    f = rng.integers(0, 1000, n).astype(np.float32)
    f[rng.random(n) < 0.01] = np.nan
    f[f == 0] = -0.0
    i = rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    keys, kw = {"nan_ties": (f, {}), "descending": (f, dict(descending=True)),
                "key_fn": (i, dict(key_fn=lambda k: (k & 1, k)))}[case]
    res = []
    for c in (gpu, parts):
        k = vex.vector(data=keys, context=c)
        v = vex.vector(data=np.arange(n, dtype=np.int64), context=c)
        merges = sort_parts.merges
        vex.sort_by_key(k, v, **kw)
        assert sort_parts.merges - merges == (6 if c is parts else 0)
        res.append((k.to_numpy(), v.to_numpy()))
    for a, b in zip(*res):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(1 << 20,), (1024, 1024),
                                   ((1 << 20) + 4,)])
def test_fft_over_parts(gpu, parts, shape, inverse, dt):
    """The four-step transform (or, for (1 << 20) + 4 points, the gathered
    one) over four parts against the one-part cuFFT transform."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(12)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    f = vex.FFT(shape, inverse=inverse, dtype=dt)
    res = []
    for c in (gpu, parts):
        xv = vex.vector(data=x, dtype=dt, context=c)
        y = vex.vector(n, dtype=dt, context=c)
        before = (cufft_execute.launches, assign_complex.launches)
        y[:] = f(xv)
        torch.cuda.synchronize()
        got = (cufft_execute.launches - before[0],
               assign_complex.launches - before[1])
        if c is gpu or n % 16:
            assert got == (1, 0)
        else:
            assert got == (2 * PARTS, (3 if len(shape) == 1 else 2) * PARTS)
        res.append(torch.from_numpy(y.to_numpy()))
    _close(torch.view_as_real(res[1]), torch.view_as_real(res[0]),
           2e-5 if dt == torch.complex64 else 1e-12)


def _keyed(n, seed=13):
    """i32 keys in runs of 63 with one run of 2^19 (longer than a part of
    2^20 + 5 over four), and a second key vector."""
    rng = np.random.default_rng(seed)
    k = (np.arange(n) // 63).astype(np.int32)
    k[1000:1000 + (1 << 19)] = k[1000]
    k2 = (rng.random(n) < 0.95).astype(np.int64)
    return k, k2


@pytest.mark.parametrize("mono", ["add", "add_integers", "max", "min"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("init", [None, 2.0])
def test_scan_by_key_over_parts(gpu, parts, mono, exclusive, init):
    n = (1 << 20) + 5
    k, k2 = _keyed(n)
    rng = np.random.default_rng(14)
    a = (rng.integers(-3, 4, n) if mono == "add_integers"
         else rng.standard_normal(n)).astype(np.float32)
    fn = vex.exclusive_scan_by_key if exclusive else vex.inclusive_scan_by_key
    name = None if mono.startswith("add") else mono
    res = []
    for c in (gpu, parts):
        keys = (vex.vector(data=k, context=c), vex.vector(data=k2, context=c))
        x = vex.vector(data=a, context=c)
        got = _launches(scan_by_key_apply, lambda: res.append(
            fn(keys, x, init=init, op_name=name).to_numpy()))
        assert got == (PARTS if c is parts else 1)
    if mono == "add":
        _close(torch.from_numpy(res[1]), torch.from_numpy(res[0]), 1e-5)
    else:
        np.testing.assert_array_equal(res[1].view(np.uint32),
                                      res[0].view(np.uint32))


def test_scan_by_key_key_eq_over_parts(gpu, parts):
    """A key predicate takes the plain route a part (the segmented scan
    kernel on its flags) with the same carries."""
    n = (1 << 20) + 5
    k, _ = _keyed(n)
    a = np.random.default_rng(15).integers(-3, 4, n).astype(np.float32)
    res = []
    for c in (gpu, parts):
        kv, x = vex.vector(data=k, context=c), vex.vector(data=a, context=c)
        got = _launches(segscan_apply, lambda: res.append(
            vex.exclusive_scan_by_key(kv, x, init=1.0, key_eq=lambda p, q:
                                      (p // 3) == (q // 3)).to_numpy()))
        assert got == (PARTS + 1 if c is parts else 1)
    np.testing.assert_array_equal(res[1].view(np.uint32),
                                  res[0].view(np.uint32))


@pytest.mark.parametrize("mono", ["add", "add_integers", "max", "min"])
def test_reduce_by_key_over_parts(gpu, parts, mono):
    n = (1 << 20) + 5
    k, k2 = _keyed(n)
    rng = np.random.default_rng(16)
    a = (rng.integers(-3, 4, n) if mono == "add_integers"
         else rng.standard_normal(n)).astype(np.float32)
    name = None if mono.startswith("add") else mono
    res = []
    for c in (gpu, parts):
        keys = (vex.vector(data=k, context=c), vex.vector(data=k2, context=c))
        got = _launches(reduce_by_key_launch, lambda: res.append(
            vex.reduce_by_key(keys, vex.vector(data=a, context=c),
                              op_name=name)))
        assert got == (PARTS if c is parts else 1)
    (ok, ov, om), (gk, gv, gm) = res
    assert gm == om and gv.nparts == PARTS
    for g, o in zip(gk, ok):
        np.testing.assert_array_equal(g.to_numpy(), o.to_numpy())
    if mono == "add":
        _close(torch.from_numpy(gv.to_numpy()),
               torch.from_numpy(ov.to_numpy()), 1e-5)
    else:
        np.testing.assert_array_equal(gv.to_numpy().view(np.uint32),
                                      ov.to_numpy().view(np.uint32))


def test_any_all_of_over_parts(gpu, parts):
    n = (1 << 20) + 5
    for last in (0.0, 1.0, float("nan")):
        a = np.zeros(n, np.float32)
        a[-1] = last
        x = vex.vector(data=a, context=parts)
        assert _launches(map_reduce, lambda: vex.any_of(x)) == PARTS
        assert vex.any_of(x) == (last != 0)
        assert vex.all_of(x + 1) and not vex.all_of(x)


def test_parts_over_distinct_cards(gpu):
    """The per-part paths with one part a card, where the host has
    several: peer copies of halos (the stencil, DIA in a CG solve),
    ghosts and the gathered x (the irregular SpMV) and the scan's tails;
    the Reductor's partials combined on the first card; the sort's
    merges, the FFT's all-to-alls, the keyed scan's carries and
    reduce_by_key's runs across cards."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices or more")
    cards = vex.Context(devices=[f"cuda:{i}" for i in range(count)],
                        set_current=False)
    n = (1 << 20) + 7
    rng = np.random.default_rng(1)
    a = rng.standard_normal(n).astype(np.float32)
    st = vex.stencil(rng.standard_normal(5).astype(np.float32), 2)
    ptr, col, val = _lognormal(n, 3)
    res = {}
    f = (np.random.default_rng(5).random(64 ** 3) - 0.5).astype(np.float32)
    for c in (gpu, cards):
        x = vex.vector(data=a, context=c)
        y = vex.vector(n, dtype=torch.float32, context=c)
        y[:] = x * st + vex.element_index()
        s = vex.inclusive_scan(x, op=torch.maximum)
        A = vex.SpMat(n, n, ptr, col, val, context=c)
        z = vex.vector(n, dtype=torch.float32, context=c)
        z[:] = A * y
        keys = vex.vector(data=(np.arange(n) // 63).astype(np.int32),
                          context=c)
        sk = vex.vector(data=a, context=c)
        sv = vex.vector(data=np.arange(n, dtype=np.int32), context=c)
        vex.sort_by_key(sk, sv)
        xf = vex.vector(data=a[:1 << 20], dtype=torch.complex64, context=c)
        fx = vex.vector(1 << 20, dtype=torch.complex64, context=c)
        fx[:] = vex.FFT(1 << 20, dtype=torch.complex64)(xf)
        kx = vex.inclusive_scan_by_key(keys, x, op_name="max")
        rk, rv, _ = vex.reduce_by_key(keys, x, op_name="min")
        got = {"y": y, "scan": s, "spmv": z, "sort_keys": sk,
               "sort_vals": sv, "keyed": kx, "rbk_keys": rk, "rbk_vals": rv}
        res.setdefault("fft", []).append(torch.from_numpy(fx.to_numpy()))
        if c is cards:
            assert [p.device for p in y.parts] == cards.devices
            g = vex.vector(n, dtype=torch.float32, context=c)
            g[:] = distributed(n, n, ptr, col, val, context=c,
                               mode="ell_a2a") * y
            got["ghost_sets"] = g
        got = {k: t.to_numpy().view(np.uint32) for k, t in got.items()}
        got["cg"] = PoissonSolver(64, context=c).solve(f, maxiter=30)
        got["sum"] = vex.Reductor(vex.SUM)(y * y)
        res[c.size] = got
    one, many = res[1], res[count]
    for k in ("y", "scan", "spmv", "sort_keys", "sort_vals", "keyed",
              "rbk_keys", "rbk_vals"):
        np.testing.assert_array_equal(many[k], one[k])
    f1, fm = res["fft"]
    _close(torch.view_as_real(fm), torch.view_as_real(f1), 2e-5)
    np.testing.assert_array_equal(many["ghost_sets"], one["spmv"])
    (u1, i1), (u, i) = one["cg"], many["cg"]
    assert i == i1
    _close(torch.from_numpy(u.to_numpy()), torch.from_numpy(u1.to_numpy()),
           1e-3)
    assert abs(many["sum"] - one["sum"]) <= 1e-5 * abs(one["sum"])
