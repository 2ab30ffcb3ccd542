"""Complex values in the generated kernels (K1, V1, the complex sum), MBA
(V1's tree and the CUDA kernel), integer division by zero, ``sign`` and
the complex rounding kernels, and the FFT API (cuFFT into its target)
against their plain versions and ``torch.fft`` on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_complex.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
from vexcl_tpu_torch.expr.triton_emit import assign_multi
from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_plain
from _cuda_common import (N, RTOL, gpu, cpu, _vec, _both, _close,
                          _kernels_launched)

pytestmark = pytest.mark.cuda


# -- complex values, the FFT and MBA -------------------------------------

CTOL = {torch.complex64: 2e-6, torch.complex128: 1e-12}


def _cclose(k, p, rtol):
    """Complex results as (re, im) pairs, within rtol of the largest
    magnitude (complex products may contract to an FMA; division is
    Smith's in both forms, rounded in another order)."""
    if k.dtype.is_complex:
        k, p = torch.view_as_real(k), torch.view_as_real(p)
    _close(k, p, rtol)


def _cvec(ctx, n, dt, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return vex.vector(data=torch.from_numpy(h).to(dt), context=ctx)


def _counted(counter, fn):
    torch.cuda.synchronize()
    before = counter.launches
    out = fn()
    torch.cuda.synchronize()
    return out, counter.launches - before


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, N])
@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_complex_assign_kernel_matches_plain(gpu, dt, n):
    """The assignment kernel on (re, im) pairs: + - * /, conj, abs, real,
    imag, casts, where, ==, a weak complex scalar, a numpy complex scalar,
    a 0-d complex tensor on the card and a real leaf; one launch, counted
    as a complex one."""
    from vexcl_tpu_torch.expr.triton_emit import assign_complex

    a, b = _cvec(gpu, n, dt, 1), _cvec(gpu, n, dt, 2)
    r = _vec(gpu, np.linspace(-2, 2, n).astype(
        np.float32 if dt == torch.complex64 else np.float64))
    z0 = torch.tensor(0.5 - 0.25j, dtype=dt, device=gpu.device)
    npc = np.complex64(1 - 2j) if dt == torch.complex64 else \
        np.complex128(1 - 2j)
    exprs = [
        a * vex.conj(b) + (2 - 1j) * r - a / (b + (3 + 1j)),
        vex.if_else(r > 0, a, -b) * npc + z0,
        vex.cast(dt, vex.abs(a) + vex.real(b) - vex.imag(a) * r),
        vex.if_else(a == a, a, b) - vex.if_else(a != b, b * 1j, a),
    ]
    for expr in exprs:
        (k, p), launched = _counted(assign_complex,
                                    lambda: _both(expr, n, dt, gpu.device))
        assert launched == 1
        _cclose(k, p, 8 * CTOL[dt])
    rdt = torch.float32 if dt == torch.complex64 else torch.float64
    k, p = _both(vex.abs(a * b) - vex.real(a), n, rdt, gpu.device)
    _close(k, p, 8 * RTOL[rdt])
    k, p = _both(a == vex.conj(vex.conj(a)), n, torch.bool, gpu.device)
    assert torch.equal(k, p) and bool(k.all())


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_complex_unaligned_views_and_permutations(gpu, dt):
    """Complex leaves at every 8-byte offset (pointers lose their 16-byte
    alignment), slices and a permutation of a complex vector (V1), and a
    target read under its own permutation (through a temporary)."""
    from vexcl_tpu_torch.expr.triton_emit import assign_complex

    n = 4099
    base = _cvec(gpu, n + 8, dt, 3).storage
    for off in range(4):
        leaf = base[off:off + n]
        k, p = _both(vex.as_expr(leaf) * (1 + 1j) + 2, n, dt, gpu.device)
        assert torch.equal(k, p)
    x = vex.vector(data=base, context=gpu)
    k, p = _both(x[3:n + 3] - x[1:n + 1] * 0.5j, n, dt, gpu.device)
    _cclose(k, p, 4 * CTOL[dt])
    perm = torch.randperm(n + 8, device=gpu.device).to(torch.int32)
    pv = vex.vector(data=perm, context=gpu)
    k, p = _both(vex.permutation(pv)(x) * 2, n + 8, dt, gpu.device)
    assert torch.equal(k, p)
    want = x.storage[perm.long()] * (1 - 1j)
    _, launched = _counted(
        assign_complex, lambda: x.assign(vex.permutation(pv)(x) * (1 - 1j)))
    assert launched == 1
    _cclose(x.storage, want, 4 * CTOL[dt])


@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_complex_tie_k1_matches_plain(gpu, cpu, dt):
    """K1 with complex targets: ``tie`` of complex vectors, the swap, and
    a real and a complex target in one launch; counted as complex."""
    from vexcl_tpu_torch.expr.triton_emit import assign_complex, assign_multi

    n = 5003
    rdt = torch.float32 if dt == torch.complex64 else torch.float64

    def run(ctx):
        x, y = _cvec(ctx, n, dt, 4), _cvec(ctx, n, dt, 5)
        m = vex.vector(n, dtype=rdt, context=ctx)
        vex.tie(x, y)[:] = (y, x)
        vex.tie(x, y, m)[:] = (x * y + 1j, x - vex.conj(y), vex.abs(x))
        return x, y, m

    before = assign_complex.launches, assign_multi.launches
    got = run(gpu)
    torch.cuda.synchronize()
    assert (assign_complex.launches - before[0],
            assign_multi.launches - before[1]) == (2, 0)
    for k, p in zip(got, run(cpu)):
        _cclose(k.storage.cpu(), p.storage, 8 * CTOL[dt])


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, N, (1 << 20) + 7])
@pytest.mark.parametrize("dt", [torch.complex64, torch.complex128])
def test_complex_sum_kernel_matches_plain(gpu, dt, n):
    """K2's complex SUM, (re, im) accumulators, alone and beside a real
    MAX and a c128 sum in one launch; each counted as complex."""
    from vexcl_tpu_torch.expr.compile import prepare_multi
    from vexcl_tpu_torch.ops.triton_reduce import (map_reduce_complex,
                                                   map_reduce_multi,
                                                   map_reduce_multi_plain)

    a = _cvec(gpu, n, dt, 6)
    r = _vec(gpu, np.random.default_rng(7).random(n))
    e, an, ty, lv = prepare(a * vex.conj(a) * 0.5 + a, n, gpu.device)
    k, launched = _counted(map_reduce_complex, lambda: map_reduce(
        e, an, ty, lv, n, "SUM", gpu.device))
    assert launched == 1 and k.dtype == dt
    p = map_reduce_plain(e, an, ty, lv, n, "SUM", gpu.device)
    tol = (1e-5 if dt == torch.complex64 else 1e-10) * max(1.0, n ** 0.5)
    assert abs(k.item() - p.item()) <= tol * max(1.0, abs(p.item()))
    assert abs(vex.Reductor(vex.SUM)(a) - a.storage.sum().item()) <= \
        tol * max(1.0, abs(a.storage.sum().item()))
    bodies, an, ty, lv = prepare_multi(
        [a * 2, r, vex.cast(torch.complex128, a) * r], n, gpu.device)
    pairs = [(bodies[0], "SUM"), (bodies[1], "MAX"), (bodies[2], "SUM")]
    ks, launched = _counted(map_reduce_complex, lambda: map_reduce_multi(
        pairs, an, ty, lv, n, gpu.device))
    assert launched == 1
    ps = map_reduce_multi_plain(pairs, an, ty, lv, n, gpu.device)
    assert [x.dtype for x in ks] == [dt, torch.float64, torch.complex128]
    for kk, pp in zip(ks, ps):
        assert abs(kk.item() - pp.item()) <= tol * max(1.0, abs(pp.item()))


def test_complex_uncovered_raise_on_card(gpu):
    """A transcendental or an order of complex values, complex MIN and
    MAX, and a complex value through a view's store raise on the card."""
    a = _cvec(gpu, 100, torch.complex64, 8)
    y = vex.vector(100, dtype=torch.complex64, context=gpu)
    for expr in (vex.exp(a), vex.sqrt(a) + 1, a ** 2):
        with pytest.raises(NotImplementedError):
            y[:] = expr
    with pytest.raises(NotImplementedError):
        vex.Reductor(vex.MIN)(a)
    with pytest.raises(NotImplementedError):
        vex.permutation(vex.element_index(0, 100))(y).assign(a * 2)


@pytest.mark.parametrize("d, form", [(2, "kernel"), (3, "kernel"),
                                     (2, "patch"), (3, "patch"),
                                     (3, "tree"), (4, "tree")])
def test_mba_kernel_matches_plain(gpu, cpu, d, form):
    """The interpolant through the API (the CUDA kernel of ``csrc/mba.cu``),
    the patch form and the lattice form's tree (the route for more than
    three axes) through V1's indexed loads, f32 and f64 queries, corners
    included: one launch of its kernel, against its plain version on the
    card and the f64 host evaluation."""
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed
    from vexcl_tpu_torch.ops import cuda_mba
    from vexcl_tpu_torch.ops.mba import _eval_level_host, mba_device_eval

    rng = np.random.default_rng(d)
    sc = [rng.random(2000) for _ in range(d)]
    ip = vex.mba((-0.01,) * d, (1.01,) * d, sc,
                 sum(np.sin(3 * c) for c in sc), grid=(4,) * d, levels=3)
    n = 70001
    q = [rng.random(n) for _ in range(d)]
    for c in q:
        c[:4] = [-0.01, 1.01, 0.0, 1.0]
    want = _eval_level_host(ip.lo, ip.hi, ip.grids[0], ip.lattice, q)
    shape = tuple(g + 3 for g in ip.grids[0])
    for npdt, tdt, tol in ((np.float32, torch.float32, 1e-5),
                           (np.float64, torch.float64, 1e-12)):
        qs = [_vec(gpu, c.astype(npdt)) for c in q]
        if form == "kernel":
            z = vex.vector(n, dtype=tdt, context=gpu)
            _, launched = _counted(cuda_mba.mba_eval,
                                   lambda: z.assign(ip(*qs)))
            k = z.storage
            p = torch.empty_like(k)
            cuda_mba.mba_plain(p, [c.storage for c in qs],
                               ip.tables(tdt, gpu.device)[0], ip.lo, ip.hi,
                               ip.grids[0])
        else:
            if form == "patch":
                assert ip.patch is not None
                expr = mba_device_eval(ip.lo, ip.hi, ip.grids, None, qs,
                                       patch=ip.tables(tdt, gpu.device)[1])
            else:
                lat = ip.tables(tdt, gpu.device)[0].reshape(shape)
                expr = mba_device_eval(ip.lo, ip.hi, ip.grids, [lat], qs)
            (k, p), launched = _counted(
                assign_indexed, lambda: _both(expr, n, tdt, gpu.device))
        assert launched == 1
        _close(k, p, 4 * RTOL[tdt])
        assert (k.double().cpu() - torch.from_numpy(want)).abs().max() <= tol


_MBA_GRID = {1: (9,), 2: (7, 5), 3: (4, 6, 5)}


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_mba_cuda_kernel_matches_plain(gpu, d, dt):
    """``csrc/mba.cu`` through its type's table against its plain version
    (the tree's plain form) on the card: the same operations in the same
    order, f32 within 1e-5 and f64 within 1e-12 of the largest magnitude; NaN and
    out-of-domain coordinates, the domain's edges, and coordinates and
    outputs off the 16-byte alignment (the scalar path) and a tail."""
    from vexcl_tpu_torch.ops import cuda_mba

    rng = np.random.default_rng(10 * d)
    sc = [rng.random(1500) for _ in range(d)]
    ip = vex.mba((-0.01,) * d, (1.01,) * d, sc,
                 sum(np.cos(2 * c) for c in sc), grid=_MBA_GRID[d],
                 levels=2, context=gpu)
    n = 10007
    lat = ip.tables(dt, gpu.device)[0]
    tab = ip.kernel_table(dt, gpu.device)
    for off in (0, 1):
        q = [torch.from_numpy(rng.random(n + 1) * 1.2 - 0.1).to(
            gpu.device, dt)[off:off + n] for _ in range(d)]
        for c in q:
            c[:5] = torch.tensor([-0.01, 1.01, float("nan"), -5.0, 7.0])
        k = torch.empty(n + 1, dtype=dt, device=gpu.device)[off:off + n]
        p = torch.empty_like(k)
        _, launched = _counted(cuda_mba.mba_eval, lambda: cuda_mba.mba_eval(
            k, q, lat, ip.lo, ip.hi, ip.grids[0], tab))
        cuda_mba.mba_plain(p, q, lat, ip.lo, ip.hi, ip.grids[0])
        torch.cuda.synchronize()
        assert launched == 1
        _close(k, p, 1e-5 if dt == torch.float32 else 1e-12)


def test_mba_api_is_one_launch_and_in_a_tree(gpu):
    """``z[:] = interp(X, Y)``: one launch of the MBA kernel and nothing
    else on the card (the profiler); ``2 * interp(X, Y) + W``: the kernel
    into a temporary and one expression launch, against the plain forms;
    two interpolants of one structure share the kernel's signature."""
    from vexcl_tpu_torch.expr.node import analyze
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed
    from vexcl_tpu_torch.ops import cuda_mba

    rng = np.random.default_rng(4)
    sx, sy = rng.random(800), rng.random(800)
    ip = vex.mba((0.0, 0.0), (1.0, 1.0), (sx, sy), sx * sy, grid=(6, 6),
                 levels=3, context=gpu)
    n = 1 << 16
    X, Y, W = (_vec(gpu, rng.random(n).astype(np.float32))
               for _ in range(3))
    z = vex.vector(n, context=gpu)
    api = ip(X, Y)
    z.assign(api)
    seen = _kernels_launched(lambda: z.assign(api))
    assert len(seen) == 1 and "mba_kernel" in seen[0][0], seen
    before = (cuda_mba.mba_eval.launches, assign_indexed.launches)
    z[:] = 2 * ip(X, Y) + W
    torch.cuda.synchronize()
    assert cuda_mba.mba_eval.launches - before[0] == 1
    assert assign_indexed.launches == before[1]
    p = torch.empty_like(z.storage)
    cuda_mba.mba_plain(p, [X.storage, Y.storage],
                       ip.tables(torch.float32, gpu.device)[0], ip.lo, ip.hi,
                       ip.grids[0])
    _close(z.storage, 2 * p + W.storage, 4 * RTOL[torch.float32])
    ip2 = vex.mba((-1.0, -1.0), (2.0, 2.0), (sx, sy), sx + sy, grid=(6, 6),
                  levels=2, context=gpu)
    assert analyze(ip(X, Y)).sig == analyze(ip2(X, Y)).sig


_DIVISION = {"floordiv": lambda a, b: a // b, "mod": lambda a, b: a % b,
             "fmod": lambda a, b: vex.fmod(a, b)}


@pytest.mark.parametrize("op", sorted(_DIVISION))
@pytest.mark.parametrize("npdt", [np.int32, np.int64, np.uint32, np.int8,
                                  np.uint16, np.bool_])
def test_integer_division_by_zero_kernel_matches_plain(gpu, npdt, op):
    """The generated kernel's ``//``, ``%`` and ``fmod`` at zero divisors
    and the least signed integer by -1, bitwise against the plain forms
    (XLA's values: -2 or -1, 0, all ones unsigned, x for two booleans)."""
    rng = np.random.default_rng(3)
    n = 5001
    if npdt is np.bool_:
        a, b = rng.random(n) < 0.5, rng.random(n) < 0.5
    else:
        info = np.iinfo(npdt)
        a = rng.integers(max(info.min, -1000), min(info.max, 1000),
                         n).astype(npdt)
        b = rng.integers(-3 if info.min else 0, 4, n).astype(npdt)
        a[:6] = [5, 0, 1, info.max, info.min, info.min]
        b[:6] = [0, 0, 0, 0, 0, -1 if info.min else 0]
    expr = _DIVISION[op](_vec(gpu, a), _vec(gpu, b))
    k, p = _both(expr, n, vex.eval(expr).dtype, gpu.device)
    assert torch.equal(k, p)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.float16, torch.complex64,
                                torch.complex128])
def test_sign_and_complex_rounding_kernels_match_plain(gpu, dt):
    """``sign`` (NaN at NaN, a zero with its sign; x/|x| of a complex
    value) and, of complex values, ``round``, ``rint`` and ``nearbyint``
    part by part, against the plain forms."""
    if dt.is_complex:
        vals = [0.5 + 1.5j, -2.5 - 0.5j, 0j, 3 + 4j, complex("inf"),
                complex("nan+1j")]
        names = ("sign", "round", "rint", "nearbyint")
    else:
        vals = [float("nan"), -0.0, 0.0, float("inf"), -float("inf"), -3.5,
                2.0, 1e-3]
        names = ("sign",)
    x = _vec(gpu, torch.tensor(vals * 40, dtype=dt))
    for name in names:
        k, p = _both(getattr(vex, name)(x), len(vals) * 40, dt, gpu.device)
        if dt.is_complex:
            k, p = torch.view_as_real(k), torch.view_as_real(p)
        assert torch.equal(torch.isnan(k), torch.isnan(p)), name
        assert torch.equal(torch.signbit(k.nan_to_num()),
                           torch.signbit(p.nan_to_num())), name
        _close(k.nan_to_num(), p.nan_to_num(), 1e-6)


def test_fft_api_writes_its_target_without_a_copy(gpu):
    """``y[:] = FFT(n)(x)``: cuFFT into y's own storage (no copy kernel
    after it), which an interop tensor that shares y's memory sees, for
    the forward and the inverse transform."""
    n = 1 << 20
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = vex.vector(data=h.to(torch.complex64), context=gpu)
    y = vex.vector(n, dtype=torch.complex64, context=gpu)
    holder = torch.utils.dlpack.from_dlpack(vex.interop.to_dlpack(y))
    f = vex.FFT(n)
    y[:] = f(x)
    seen = _kernels_launched(lambda: y.assign(f(x)))
    assert not any(w in k.lower() for k, _ in seen
                   for w in ("copy", "elementwise", "memcpy")), seen
    ref = torch.fft.fft(x.storage.to(torch.complex128))
    assert ((holder.to(torch.complex128) - ref).norm()
            / ref.norm()).item() <= 1e-5
    y[:] = vex.FFT(n, inverse=True)(x)
    ref = torch.fft.ifft(x.storage.to(torch.complex128))
    assert ((holder.to(torch.complex128) - ref).norm()
            / ref.norm()).item() <= 1e-5


def test_fft_plan_into_an_out_of_another_type_or_device(gpu):
    """A c64 plan called with a c128 ``out`` takes ``torch.fft`` (cast into
    ``out``), not cuFFT over ``out``'s memory; an ``out`` on another device
    raises, as ``torch.fft.fftn(out=)`` does; a c64 ``out`` takes cuFFT."""
    from vexcl_tpu_torch.ops.fft import Plan

    n = 1 << 12
    rng = np.random.default_rng(12)
    h = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = h.to(gpu.device, torch.complex64)
    ref = torch.fft.fft(x.to(torch.complex128))
    plan = Plan((n,), None, False, torch.complex64)
    for dt in (torch.complex128, torch.complex64):
        out = torch.zeros(n, dtype=dt, device=gpu.device)
        assert plan(x, out) is out
        err = ((out.to(torch.complex128) - ref).norm() / ref.norm()).item()
        assert err <= 1e-5, (dt, err)
    with pytest.raises(RuntimeError):
        plan(x, torch.zeros(n, dtype=torch.complex64))


def test_fft_api_matches_torch_fft_c128(gpu):
    """The FFT API (cuFFT, and the ct engine's planar products) against
    ``torch.fft`` in c128 on the same input: c64 within 1e-5 relative L2,
    c128 within 1e-12; the round trip; 1-D, a prime, 2-D, batched."""
    rng = np.random.default_rng(9)
    cases = [((1 << 12,), None), ((1 << 16,), None), ((3 * 5 * 7 * 64,), None),
             ((1009,), None), ((128, 96), None), ((64, 256), (1,))]
    for shape, dims in cases:
        n = int(np.prod(shape))
        h = torch.from_numpy(rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
        for dt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            for impl in ("xla", "ct"):
                x = vex.vector(data=h.to(dt), context=gpu)
                y = vex.vector(n, dtype=dt, context=gpu)
                y[:] = vex.FFT(shape, dims=dims, dtype=dt, impl=impl)(x)
                ref = torch.fft.fftn(
                    x.storage.to(torch.complex128).view(shape),
                    dim=dims).reshape(-1)
                err = ((y.storage.to(torch.complex128) - ref).norm()
                       / ref.norm()).item()
                assert err <= tol, (shape, dt, impl, err)
                z = vex.vector(n, dtype=dt, context=gpu)
                z[:] = vex.FFT(shape, dims=dims, dtype=dt, inverse=True,
                               impl=impl)(y)
                back = ((z.storage - x.storage).norm()
                        / x.storage.norm()).item()
                assert back <= 2 * tol, (shape, dt, impl, back)
