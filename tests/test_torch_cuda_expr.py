"""The map-reduce (one persistent launch, NaN-propagating MIN/MAX), the
k-output assignment kernel (``tie``, multivectors, the generator, the
Lorenz step against raw CUDA), the several-accumulator reduction, and
the launch path (``_build.TritonLauncher``'s records, argument classes,
two streams, unsigned, boolean and 0-d leaves, ``Ap`` into its target)
against their plain versions on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_expr.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
from vexcl_tpu_torch.expr.triton_emit import (assign,
    assign_multi,
    assign_multi_plain,
    assign_plain)
from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_plain
from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec
from vexcl_tpu_torch.types import dtype_of_code
from _cuda_common import N, RTOL, gpu, cpu, _vec, _both, _close, _bitwise

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["SUM", "MIN", "MAX"])
# one element, a tile less one, one tile, and (5 << 20) + 777: 1281 tiles
# of 4096, so on a 132-SM card the persistent grid's last round is ragged
@pytest.mark.parametrize("n", [1, 4095, 4096, 1000, N, (1 << 20) + 12345,
                               (5 << 20) + 777])
def test_map_reduce_kernel_matches_plain(gpu, kind, dt, n):
    """One launch per reduction, the plain result within tolerance, and
    the same bits from three calls."""
    rng = np.random.default_rng(4)
    npdt = np.float64 if dt == torch.float64 else np.float32
    x = _vec(gpu, rng.random(n).astype(npdt))
    y = _vec(gpu, rng.random(n).astype(npdt) - 0.5)
    for expr in (x * y, vex.exp(x)):
        e, analysis, types, leaves = prepare(expr, n, gpu.device)
        before = map_reduce.launches
        ks = [map_reduce(e, analysis, types, leaves, n, kind, gpu.device)
              for _ in range(3)]
        assert map_reduce.launches == before + 3
        assert all(torch.equal(a, ks[0]) for a in ks[1:])
        k = ks[0].item()
        p = map_reduce_plain(e, analysis, types, leaves, n, kind,
                             gpu.device).item()
        tol = {torch.float32: 1e-5, torch.float64: 1e-10}[dt]
        if kind == "SUM":
            assert abs(k - p) <= tol * max(1.0, abs(p)), (k, p)
        else:
            assert k == p


def test_map_reduce_on_two_streams(gpu):
    """Reductions enqueued on two streams at once each get their own
    partials and ticket: every result is right."""
    n = 1 << 22
    a = _vec(gpu, np.ones(n, np.float32))
    b = _vec(gpu, np.full(n, 2, np.float32))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    res = []
    for _ in range(20):
        for s, v in ((s1, a), (s2, b)):
            with torch.cuda.stream(s):
                e, analysis, types, leaves = prepare(v * 1.0, n, gpu.device)
                res.append((map_reduce(e, analysis, types, leaves, n, "SUM",
                                       gpu.device), float(v.storage[0]) * n))
    torch.cuda.synchronize()
    assert all(r.item() == want for r, want in res)
    i = _vec(gpu, np.arange(100000, dtype=np.int32))
    assert vex.Reductor(vex.SUM)(i * 3) == 3 * 99999 * 100000 // 2


def test_reductor_raises_on_uncovered_kinds(gpu):
    """What the map-reduce kernels do not cover raises on the card: MIN or
    MAX of booleans, complex values, a builtin of a complex value (every
    builtin has a kernel form for real types)."""
    x = _vec(gpu, np.ones(100, np.float32))
    with pytest.raises(NotImplementedError):
        vex.Reductor(vex.MIN_MAX)(x > 0)
    with pytest.raises(NotImplementedError):
        vex.Reductor(vex.SUM_Kahan)(_vec(gpu, np.ones(100, np.complex64)))
    with pytest.raises(NotImplementedError, match="sinpi"):
        y = vex.vector(100, dtype=torch.complex64, context=gpu)
        y[:] = vex.sinpi(_vec(gpu, np.ones(100, np.complex64)))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["MIN", "MAX"])
@pytest.mark.parametrize("where", ["first_block", "last_partial_block",
                                   "nowhere"])
def test_map_reduce_min_max_propagate_nan(gpu, kind, dt, where):
    from vexcl_tpu_torch.ops.triton_reduce import REDUCE_BLOCK

    n = 3 * REDUCE_BLOCK + 123
    rng = np.random.default_rng(40)
    npdt = np.float64 if dt == torch.float64 else np.float32
    h = rng.random(n).astype(npdt) - 0.5
    if where == "first_block":
        h[17] = np.nan
    elif where == "last_partial_block":
        h[n - 5] = np.nan
    x = _vec(gpu, h)
    e, analysis, types, leaves = prepare(x * 2, n, gpu.device)
    k = map_reduce(e, analysis, types, leaves, n, kind, gpu.device).item()
    p = map_reduce_plain(e, analysis, types, leaves, n, kind,
                         gpu.device).item()
    if where == "nowhere":
        assert k == p
    else:
        assert np.isnan(k) and np.isnan(p)
    api = vex.Reductor(getattr(vex, kind))(x * 2)
    assert np.isnan(api) if where != "nowhere" else api == k


# -- the k-output assignment kernel: tie, multivector, the generator -----

def _both_multi(exprs, n, dtypes, device):
    """(kernel results, plain results) of one fused assignment into new
    targets, checked to be one launch."""
    from vexcl_tpu_torch.expr.compile import prepare_multi
    from vexcl_tpu_torch.expr.triton_emit import (assign_multi,
                                                  assign_multi_plain)

    exprs, analysis, types, leaves = prepare_multi(exprs, n, device)
    ks = [torch.empty(n, dtype=d, device=device) for d in dtypes]
    ps = [torch.empty_like(k) for k in ks]
    before = assign_multi.launches
    assign_multi(exprs, analysis, types, leaves, ks)
    assert assign_multi.launches == before + 1
    assign_multi_plain(exprs, analysis, types, leaves, ps)
    torch.cuda.synchronize()
    return ks, ps


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 1024, 1025, (1 << 24) + 3])
def test_assign_multi_matches_plain(gpu, k, n):
    """k outputs sharing a subexpression; one element, one block, a block
    and one, and a ragged 2^24 + 3."""
    rng = np.random.default_rng(31)
    x, y = (_vec(gpu, rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    s = x * y
    exprs = [s * (i + 1) + vex.sin(y) * i - i for i in range(k)]
    ks, ps = _both_multi(exprs, n, [torch.float32] * k, gpu.device)
    for a, b in zip(ks, ps):
        _close(a, b, 4 * RTOL[torch.float32])


@pytest.mark.parametrize("dtypes", [
    (torch.float32,), (torch.float64,), (torch.int32,),
    (torch.float32, torch.float64, torch.int32),
    (torch.int32, torch.float32, torch.float64, torch.float32)])
def test_assign_multi_output_types(gpu, dtypes):
    """Each output cast to its target's type: f32, f64 and i32, mixed."""
    rng = np.random.default_rng(32)
    x = _vec(gpu, rng.standard_normal(N) * 100)
    i = _vec(gpu, rng.integers(-1000, 1000, N).astype(np.int32))
    exprs = [x * (j + 1) + i * j for j in range(len(dtypes))]
    ks, ps = _both_multi(exprs, N, list(dtypes), gpu.device)
    for a, b, d in zip(ks, ps, dtypes):
        assert a.dtype == d
        if d.is_floating_point:
            _close(a, b, RTOL[d])
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_assign_multi_compound_swap_and_targets_that_are_leaves(gpu, dt):
    """``=`` and ``+=`` in one kernel, the swap, and targets read as
    leaves: every load before the first store, one launch a call."""
    from vexcl_tpu_torch.expr.compile import evaluate_multi
    from vexcl_tpu_torch.expr.triton_emit import assign_multi

    rng = np.random.default_rng(33)
    npdt = np.float64 if dt == torch.float64 else np.float32
    n = (1 << 24) + 3
    x, y, z = (_vec(gpu, rng.standard_normal(n).astype(npdt))
               for _ in range(3))
    hx, hy, hz = (v.storage.clone() for v in (x, y, z))
    before = assign_multi.launches
    evaluate_multi([y * 2, x + z, z * z], [x.storage, y.storage, z.storage],
                   ["+=", "=", "-="])
    assert torch.equal(x.storage, hx + hy * 2)    # y * 2 is exact
    assert torch.equal(y.storage, hx + hz)
    _close(z.storage, hz - hz * hz, RTOL[dt])      # may contract to an FMA
    hx, hy = x.storage.clone(), y.storage.clone()
    vex.tie(x, y)[:] = (y, x)
    assert torch.equal(x.storage, hy) and torch.equal(y.storage, hx)
    vex.tie(x, y)[:] = (x + y, x - y)
    assert torch.equal(x.storage, hy + hx) and torch.equal(y.storage,
                                                           hy - hx)
    m = vex.multivector(components=[x, y, z], context=gpu)
    hm = [v.storage.clone() for v in (x, y, z)]
    m += vex.fabs(m) * 0.5
    for v, h in zip((x, y, z), hm):
        _close(v.storage, h + h.abs() * 0.5, RTOL[dt])
    torch.cuda.synchronize()
    assert assign_multi.launches == before + 4


def _reduce_pairs(bodies, kinds, n, device):
    from vexcl_tpu_torch.expr.compile import prepare_multi

    bodies, analysis, types, leaves = prepare_multi(bodies, n, device)
    return [(b, k) for b in bodies for k in kinds], analysis, types, leaves


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int32])
@pytest.mark.parametrize("k,kinds", [
    (1, ("MIN", "MAX")), (1, ("SUM", "MIN", "MAX")), (3, ("SUM",)),
    (3, ("MIN", "MAX")), (2, ("SUM_Kahan", "MAX"))])
@pytest.mark.parametrize("n", [1, 4095, (5 << 20) + 777])
def test_map_reduce_multi_matches_plain(gpu, k, kinds, dt, n):
    """One launch for every (body, kind) of k bodies, the same bits from
    three calls, MIN and MAX exact, sums within tolerance of the plain
    version."""
    from vexcl_tpu_torch.ops.triton_reduce import (map_reduce_multi,
                                                   map_reduce_multi_plain)

    rng = np.random.default_rng(34)
    npdt = {torch.float32: np.float32, torch.float64: np.float64,
            torch.int32: np.int32}[dt]
    xs = [_vec(gpu, (rng.random(n) * 200 - 100).astype(npdt))
          for _ in range(k)]
    pairs, analysis, types, leaves = _reduce_pairs(
        [x * 2 + j for j, x in enumerate(xs)], kinds, n, gpu.device)
    before = map_reduce_multi.launches
    runs = [map_reduce_multi(pairs, analysis, types, leaves, n, gpu.device)
            for _ in range(3)]
    assert map_reduce_multi.launches == before + 3
    plain = map_reduce_multi_plain(pairs, analysis, types, leaves, n,
                                   gpu.device)
    tol = {torch.float32: 1e-5, torch.float64: 1e-10, torch.int32: 0}[dt]
    for j, ((_, kind), p) in enumerate(zip(pairs, plain)):
        got = [r[j] for r in runs]
        assert all(torch.equal(g, got[0]) for g in got[1:])
        g, p = got[0].item(), p.item()
        if kind.startswith("SUM"):
            assert abs(g - p) <= tol * max(1.0, abs(p)), (kind, g, p)
        else:
            assert g == p, (kind, g, p)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", [0, 4096 * 3 + 5, (1 << 20) + 2])
def test_min_max_with_nan_and_integers(gpu, dt, where):
    rng = np.random.default_rng(35)
    n = (1 << 20) + 3
    npdt = np.float64 if dt == torch.float64 else np.float32
    h = (rng.random(n) - 0.5).astype(npdt)
    h[where] = np.nan
    mn, mx = vex.Reductor(vex.MIN_MAX)(_vec(gpu, h) * 3)
    assert mn != mn and mx != mx
    i = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    assert vex.Reductor(vex.MIN_MAX)(_vec(gpu, i)) == (int(i.min()),
                                                       int(i.max()))
    assert vex.Reductor(vex.CombineReductors(vex.SUM, vex.MIN, vex.MAX))(
        _vec(gpu, i)) == (int(i.astype(np.int64).sum()), int(i.min()),
                          int(i.max()))


def test_kahan_sum_on_the_card(gpu):
    """1.0 followed by 2^24 values of 1e-8: the kernel's compensated sum
    is within 2 f32 ulp of the f64 sum and no farther off than its plain
    version (compensated over chunks of 4096 only); on random values it
    agrees with the plain version within 1e-6; the same bits each call."""
    from vexcl_tpu_torch.ops.triton_reduce import kahan_sum_plain

    n = (1 << 24) + 1
    h = np.full(n, 1e-8, np.float32)
    h[0] = 1.0
    x = _vec(gpu, h)
    exact = float(h.astype(np.float64).sum())
    ulp = float(np.spacing(np.float32(exact)))
    got = [vex.Reductor(vex.SUM_Kahan)(x) for _ in range(3)]
    assert got[0] == got[1] == got[2]
    plain = kahan_sum_plain(x.storage).item()
    assert abs(got[0] - exact) <= 2 * ulp, (got[0], exact)
    assert abs(got[0] - exact) <= abs(plain - exact)
    r = _vec(gpu, np.random.default_rng(36).random(n).astype(np.float32))
    k = vex.Reductor(vex.SUM_Kahan)(r * 2)
    p = kahan_sum_plain(r.storage * 2).item()
    assert abs(k - p) <= 1e-6 * abs(p)


def test_reductor_kinds_are_one_launch_without_a_plain_path(gpu,
                                                            monkeypatch):
    from vexcl_tpu_torch.ops import triton_reduce
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce_multi

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain reduction ran on the card")
    monkeypatch.setattr(triton_reduce, "map_reduce_multi_plain", no_plain)
    monkeypatch.setattr(triton_reduce, "plain_values", no_plain)
    rng = np.random.default_rng(37)
    h = rng.random((3, N)).astype(np.float32)
    x = _vec(gpu, h[0])
    m = vex.multivector(data=h, context=gpu)
    calls = [lambda: vex.Reductor(vex.MIN_MAX)(x),
             lambda: vex.Reductor(vex.CombineReductors(vex.SUM, vex.MAX))(x),
             lambda: vex.Reductor(vex.SUM_Kahan)(x),
             lambda: vex.Reductor(vex.SUM)(m),
             lambda: vex.Reductor(vex.MIN_MAX)(m * 2)]
    for call in calls:
        before = map_reduce_multi.launches
        call()
        assert map_reduce_multi.launches == before + 1
    assert vex.Reductor(vex.MAX)(m) == tuple(float(r.max()) for r in h)


def test_map_reduce_multi_on_two_streams(gpu):
    """Several-word reductions enqueued on two streams at once each get
    their own partials and ticket: every result is right."""
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce_multi

    n = 1 << 22
    a = _vec(gpu, np.ones(n, np.float32))
    b = _vec(gpu, np.full(n, 2, np.float32))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    kinds = ("SUM_Kahan", "MIN", "MAX")
    torch.cuda.synchronize()
    res = []
    for _ in range(20):
        for s, v, c in ((s1, a, 1.0), (s2, b, 2.0)):
            with torch.cuda.stream(s):
                args = _reduce_pairs([v * 1.0], kinds, n, gpu.device)
                res.append((map_reduce_multi(*args, n, gpu.device),
                            (c * n, c, c)))
    torch.cuda.synchronize()
    assert all(tuple(r.item() for r in got) == want for got, want in res)


RAW_LORENZ = r'''
template <typename T>
__device__ void rk4(const T* x, T* y, T* z, const T* R, T* xo, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const T s = T(10.0), b = T(8.0 / 3.0), h = T(0.01), h2 = T(0.5 * 0.01),
            h6 = T(0.01 / 6.0);
    T X = x[i], Y = y[i], Z = z[i], r = R[i];
    T ax = s * (Y - X), ay = r * X - Y - X * Z, az = X * Y - b * Z;
    T x2 = X + h2 * ax, y2 = Y + h2 * ay, z2 = Z + h2 * az;
    T bx = s * (y2 - x2), by = r * x2 - y2 - x2 * z2, bz = x2 * y2 - b * z2;
    T x3 = X + h2 * bx, y3 = Y + h2 * by, z3 = Z + h2 * bz;
    T cx = s * (y3 - x3), cy = r * x3 - y3 - x3 * z3, cz = x3 * y3 - b * z3;
    T x4 = X + h * cx, y4 = Y + h * cy, z4 = Z + h * cz;
    T dx = s * (y4 - x4), dy = r * x4 - y4 - x4 * z4, dz = x4 * y4 - b * z4;
    xo[i] = X + h6 * (ax + T(2) * bx + T(2) * cx + dx);
    y[i] = Y + h6 * (ay + T(2) * by + T(2) * cy + dy);
    z[i] = Z + h6 * (az + T(2) * bz + T(2) * cz + dz);
}
extern "C" __global__ void lorenz_f32(const float* x, float* y, float* z,
                                      const float* R, float* xo,
                                      long long n) {
    rk4(x, y, z, R, xo, n);
}
extern "C" __global__ void lorenz_f64(const double* x, double* y, double* z,
                                      const double* R, double* xo,
                                      long long n) {
    rk4(x, y, z, R, xo, n);
}
'''


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_lorenz_step_against_plain_and_raw_cuda(gpu, dt):
    """One launch a step; the state after 1 and 10 steps against the plain
    version of the same recorded tree and a hand-written CUDA RK4 kernel:
    f32 1e-5 after one step and 1e-4 after ten (FMA contraction differs;
    the system is chaotic), f64 1e-12 and 1e-10."""
    from vexcl_tpu_torch.expr.triton_emit import (assign_multi,
                                                  assign_multi_plain)
    from vexcl_tpu_torch.models import LorenzEnsemble

    npdt = np.float64 if dt == torch.float64 else np.float32
    tol = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-10)}[dt]
    m = LorenzEnsemble((1 << 16) + 5, dtype=npdt, context=gpu)
    ref = LorenzEnsemble.from_arrays(*(v.storage.clone() for v in
                                       (m.x, m.y, m.z, m.R)), context=gpu)
    raw = vex.CustomKernel(RAW_LORENZ, name=f"lorenz_f{str(dt)[-2:]}")
    rx, ry, rz, rR = (vex.vector(data=v.storage, context=gpu)
                      for v in (m.x, m.y, m.z, m.R))
    plain = ref._step.prepare(ref.x, ref.y, ref.z, ref.R)
    for steps, t in zip((1, 9), tol):
        before = assign_multi.launches
        m.step(steps)
        torch.cuda.synchronize()
        assert assign_multi.launches == before + steps
        for _ in range(steps):
            assign_multi_plain(*plain)
            rx = raw(rx, ry, rz, rR)
        for a, p, r in zip((m.x, m.y, m.z), (ref.x, ref.y, ref.z),
                           (rx, ry, rz)):
            assert a.dtype == dt
            _close(a.storage, p.storage, t)
            _close(a.storage, r.storage, t)


# -- the launch path: records and the direct launch (_build.TritonLauncher) --
#
# Every generated kernel form, run from raw tensor leaves at element
# offset ``off``: its results (moves, MIN, MAX bitwise; the sums of one
# kernel repeat bit for bit on one card).  Against the plain version: sums
# 1e-5 (f32, another order), the rest bitwise.

_G = 64


def _launch_forms(ctx, off):
    """name -> (counter, a function running that form once and returning
    its results) for leaves at element ``off`` of their buffers."""
    from vexcl_tpu_torch.expr.compile import evaluate, evaluate_multi
    from vexcl_tpu_torch.expr.triton_emit import (assign, assign_indexed,
                                                  assign_multi,
                                                  assign_to_view)
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_multi
    from vexcl_tpu_torch.ops.triton_reduce_view import reduce_view_apply

    dev, n, g = ctx.device, _G * _G, _G
    h = np.random.default_rng(5).random(2 * n + 16).astype(np.float32) - 0.5
    base = torch.from_numpy(h).to(dev)
    a, b = base[off:off + n], base[n + 8 + off:2 * n + 8 + off]
    perm = np.random.default_rng(6).permutation(n)
    idx = torch.from_numpy(perm).to(dev)
    o = vex.vector(n, context=ctx)

    def to_view():
        o[perm] = a * 2
        return [o.storage.clone()]

    return {
        "assign": (assign, lambda: [evaluate(2 * a + vex.sin(b), n=n,
                                             device=dev)]),
        "indexed": (assign_indexed, lambda: [evaluate(
            vex.permutation(idx)(a) * 2, n=n, device=dev)]),
        "tiled": (assign_indexed, lambda: [evaluate(
            vex.reshape(a, (g, g), (1, 0)), n=n, device=dev)]),
        "multi": (assign_multi, lambda: list(evaluate_multi(
            [a + b, a * b - 1], n=n, device=dev))),
        "reduce": (map_reduce, lambda: [torch.tensor(
            vex.Reductor(vex.SUM, context=ctx)(a * b))]),
        "reduce_multi": (map_reduce_multi, lambda: [torch.tensor(
            vex.Reductor(vex.MIN_MAX, context=ctx)(a))]),
        "reduce_view": (reduce_view_apply, lambda: [evaluate(
            vex.reduce_view("sum", vex.slicer((g, g))[:, :](a), 1),
            device=dev)]),
        "reduce_view_split": (reduce_view_apply, lambda: [evaluate(
            vex.reduce_view("max", vex.slicer((512, 8))[:, :](a), 0),
            device=dev)]),
        "to_view": (assign_to_view, to_view),
    }


_FORMS = ("assign", "indexed", "tiled", "multi", "reduce", "reduce_multi",
          "reduce_view", "reduce_view_split", "to_view")


def _agree(k, p, exact):
    k, p = k.cpu(), p.cpu()
    if exact:
        _bitwise(k, p)
    else:
        _close(k, p, 1e-5)


@pytest.mark.parametrize("form", _FORMS)
def test_direct_launch_same_bits_as_jit(gpu, cpu, form, monkeypatch):
    """Each form: the direct launch of its record writes the same bits
    as Triton's ``fn[grid]``; one launch a call; a leaf offset by one
    element after warm calls on aligned ones gets its own record and the
    plain version's result."""
    from vexcl_tpu_torch._build import TritonLauncher

    counter, run = _launch_forms(gpu, 0)[form]
    run()                                 # the record: through fn[grid]
    before = counter.launches
    direct = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(TritonLauncher, "__call__", TritonLauncher.jit_launch)
        jit = run()
    torch.cuda.synchronize()
    for d, j in zip(direct, jit):
        _bitwise(d, j)
    exact = form not in ("reduce", "reduce_view", "multi", "assign")
    for off in (1, 0, 1):
        got = _launch_forms(gpu, off)[form][1]()
        want = _launch_forms(cpu, off)[form][1]()
        for k, p in zip(got, want):
            _agree(k, p, exact)


def test_launch_classes_match_tritons_binder(gpu):
    """For the assignment kernel, arguments that ``arg_classes`` puts in
    one class are ones Triton's own binder specialises alike: pointers at
    every offset, integer scalars of every width, f64 scalars as bits,
    element counts of every class; a complex leaf (a pointer to its real
    type) at every 8-byte offset and a complex scalar."""
    from triton import knobs

    from vexcl_tpu_torch._build import arg_classes
    from vexcl_tpu_torch.cache import kernel_cache
    from vexcl_tpu_torch.expr.node import as_expr
    from vexcl_tpu_torch.expr.triton_emit import (launch_args, launch_key,
                                                  tensor_arg)

    dev = gpu.device
    buf = torch.zeros(4096 + 64, device=dev)
    e, an, ty, lv = prepare(as_expr(buf[:4096]) * 2.5 + 3, 4096, dev)
    k = torch.empty(4096, device=dev)
    assign(e, an, ty, lv, k)
    key, _ = launch_key([e], an, [torch.float32])
    launcher = kernel_cache.get(key).launcher
    binder = launcher.fn.device_caches[dev.index][4]
    kw = dict(zip(launcher.constexprs, (1024,)), debug=knobs.runtime.debug,
              instrumentation_mode=knobs.compilation.instrumentation_mode)
    seen = {}
    for off in range(9):
        for n in (1, 2, 16, 17, (1 << 31) + 16):
            for s, i in ((2.5, 3), (0.0, 1), (-1.0, (1 << 31) + 1),
                         (1e300, (1 << 63) + 5)):
                args = [k, *launch_args([buf[off:off + 4096], s, i]), n]
                cls = arg_classes(args, launcher.specialized)
                spec = str(binder(*args, **kw)[1])
                assert seen.setdefault(cls, spec) == spec, (off, n, s, i)
    assert len(seen) >= 8
    # a complex leaf: a pointer to its real type at every 8-byte offset,
    # and a complex scalar as two numbers
    cbuf = torch.zeros(4096 + 64, dtype=torch.complex64, device=dev)
    e, an, ty, lv = prepare(as_expr(cbuf[:4096]) * (2.5 + 1j) + 3, 4096, dev)
    kc = torch.empty(4096, dtype=torch.complex64, device=dev)
    assign(e, an, ty, lv, kc)
    key, _ = launch_key([e], an, [torch.complex64])
    launcher = kernel_cache.get(key).launcher
    binder = launcher.fn.device_caches[dev.index][4]
    seen = {}
    for off in range(5):
        for n in (1, 16, 17):
            for s in ((2.5 + 1j), (0.0 + 0j), (-1e300 + 1e-300j)):
                args = [*map(tensor_arg, [kc]),
                        *launch_args([cbuf[off:off + 4096], s, 3]), n]
                cls = arg_classes(args, launcher.specialized)
                spec = str(binder(*args, **kw)[1])
                assert seen.setdefault(cls, spec) == spec, (off, n, s)
    assert len(seen) >= 4


def test_launches_on_two_streams(gpu, cpu):
    """The assignment, K1 and V2 forms enqueued on two streams in turn:
    each launch reads its own stream; every result right."""
    forms = _launch_forms(gpu, 0)
    want = {f: _launch_forms(cpu, 0)[f][1]() for f in
            ("assign", "multi", "reduce_view_split")}
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    got = []
    torch.cuda.synchronize()
    for _ in range(10):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                for f in want:
                    got.append((f, forms[f][1]()))
    torch.cuda.synchronize()
    for f, res in got:
        for k, p in zip(res, want[f]):
            _agree(k, p, f == "reduce_view_split")


@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_unsigned_expressions_match_plain(gpu, dt):
    """Unsigned arithmetic in the kernel's native types against the plain
    forms' signed carriers: wrapping, order, division, shifts, bitwise."""
    top = {np.uint16: 1 << 16, np.uint32: 1 << 32, np.uint64: 1 << 64}[dt]
    n = 4099
    a = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)).astype(dt)
    a[:3] = [top // 2, top - 1, top // 2 + 5]
    b = a[::-1].copy() | dt(1)
    x, y = _vec(gpu, a), _vec(gpu, b)
    exprs = [x + x, x - y, x * y, x // y, x % y, x >> 3, x << 2, ~x, -x,
             x ^ y, vex.max(x, y), vex.min(x, y), vex.if_else(x > y, x, y),
             x < y, abs(x), vex.fdim(x, y), vex.abs_diff(x, y),
             vex.hadd(x, y), vex.rhadd(x, y)]
    for expr in exprs:
        e, an, ty, lv = prepare(expr, n, gpu.device)
        code = ty[id(e)]
        k = torch.empty(n, dtype=dtype_of_code(code),
                        device=gpu.device)
        p = torch.empty_like(k)
        assign(e, an, ty, lv, k)
        assign_plain(e, an, ty, lv, p)
        _bitwise(k, p)
    for kind in ("MIN", "MAX", "SUM"):
        e, an, ty, lv = prepare(x ^ y, n, gpu.device)
        kr = map_reduce(e, an, ty, lv, n, kind, gpu.device).cpu()
        pr = map_reduce_plain(e, an, ty, lv, n, kind, gpu.device).cpu()
        assert kr.item() == pr.item(), kind


def test_boolean_expressions_match_plain(gpu):
    n = 4099
    bh = np.arange(n) % 3 == 0
    b, t = _vec(gpu, bh), _vec(gpu, np.ones(n, dtype=bool))
    for expr in (abs(b), b // t, b % t, b << b, b >> t, (b & t) | b,
                 vex.if_else(b, t, b), vex.min(b, t)):
        e, an, ty, lv = prepare(expr, n, gpu.device)
        k = torch.empty(n, dtype=dtype_of_code(ty[id(e)]),
                        device=gpu.device)
        p = torch.empty_like(k)
        assign(e, an, ty, lv, k)
        assign_plain(e, an, ty, lv, p)
        _bitwise(k, p)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.int64])
def test_zero_d_leaves_on_the_card(gpu, dt):
    """A 0-d CUDA tensor leaf is loaded once in the kernel and broadcast
    (never read on the host); a 0-d CPU one crosses as a scalar of its
    type; both against the plain version, and ``x[:] = t``."""
    n = 4099
    x = _vec(gpu, np.arange(n, dtype=np.float32))
    for t in (torch.tensor(3, dtype=dt, device=gpu.device),
              torch.tensor(3, dtype=dt)):
        k, p = _both((x + t) * t, n, torch.promote_types(dt, torch.float32)
                     if dt != torch.int64 else torch.float32, gpu.device)
        _bitwise(k, p)
        y = _vec(gpu, np.zeros(n, np.float32))
        y[:] = t
        assert torch.equal(y.storage.cpu(), torch.full((n,), 3.0))
        assert vex.Reductor(vex.SUM)(vex.sin(2.0) + x) == pytest.approx(
            float((torch.arange(n) + np.sin(2.0)).sum()), rel=1e-6)


def test_spmv_into_its_target_on_the_card(gpu):
    """``Ap[:] = A * p`` writes the DIA kernel's product into Ap (one
    DIA launch, no copy kernel), the same bits as the product alone;
    ``x[:] = A * x`` keeps its temporary and the right answer."""
    from vexcl_tpu_torch.utils.poisson import poisson_7pt

    ptr, col, val = poisson_7pt(16, dtype=np.float32)
    n = 16 ** 3
    A = vex.SpMat(n, n, ptr, col, val, context=gpu)
    p = _vec(gpu, np.random.default_rng(2).random(n).astype(np.float32))
    Ap = vex.vector(n, context=gpu)
    want = A._matvec(p.storage)
    before = dia_matvec.launches
    Ap[:] = A * p
    torch.cuda.synchronize()
    assert dia_matvec.launches == before + 1
    _bitwise(Ap.storage, want)
    p[:] = A * p
    _bitwise(p.storage, want)
