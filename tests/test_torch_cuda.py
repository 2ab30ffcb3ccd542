"""The port's kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports neither jax nor vexcl_tpu, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 results may differ from the plain version by a few ulp
(FMA contraction, libdevice against PyTorch's own math, another summation
order): 2e-6 relative to the largest magnitude, 1e-5 for sums.  f64: 1e-12
and 1e-10 for sums.  The builtins' sweep holds each element within 4
times that of the plain value's magnitude (absolutely below 1).  MIN,
MAX, integer results and the DIA kernel on integer-valued data are
exact.  Scans: f32 sums 1e-5 relative to the
largest magnitude (another summation order), f64 1e-12, bf16 1e-2 (a sum
carried in f32 in another order may round to a neighbouring bf16);
MAX/MIN, integer scans and compaction bitwise; a scan repeated on the same
input (and alignment) bitwise; the keyed kernel bitwise against the route
it replaces (segment flags, segscan, compaction, the exclusive epilogue)
and within the scan tolerances of its plain versions.  Random numbers: Philox
words, uniforms and the known answers bitwise; normals (libdevice
log/cos/sqrt against PyTorch's) 8e-6 (f32), 4e-12 (f64) and 1e-2 (bf16,
where a few-ulp f32 difference may round to the neighbouring bf16).  User
kernels: 2e-7 for ``2*x + y`` (FMA contraction).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
from vexcl_tpu_torch.expr.triton_emit import (assign, assign_multi,
                                              assign_multi_plain,
                                              assign_plain)
from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_plain
from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec, dia_matvec_plain
from vexcl_tpu_torch.types import dtype_of_code
from chip_smoke import BUILTIN_DOMAIN, BUILTIN_INTEGER
from _grad_tables import GRAD_DOMAIN, NOT_DIFFERENTIABLE

pytestmark = pytest.mark.cuda

N = (1 << 16) + 123
RTOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return vex.Context(vex.Filter.GPU)


def _vec(ctx, data):
    return vex.vector(data=data, context=ctx)


def _both(expr, n, dtype, device):
    """(kernel result, plain result) of one assignment."""
    e, analysis, types, leaves = prepare(expr, n, device)
    k = torch.empty(n, dtype=dtype, device=device)
    p = torch.empty(n, dtype=dtype, device=device)
    assign(e, analysis, types, leaves, k)
    assign_plain(e, analysis, types, leaves, p)
    torch.cuda.synchronize()
    return k, p


def _close(k, p, rtol):
    k, p = k.double().cpu(), p.double().cpu()
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    fin = ~torch.isnan(p)
    scale = max(1.0, p[fin].abs().max().item()) if fin.any() else 1.0
    err = (k[fin] - p[fin]).abs().max().item() if fin.any() else 0.0
    assert err <= rtol * scale, (err, scale)


def _close_each(k, p, rtol):
    """Element by element: each finite value within rtol of the plain
    value's magnitude (absolutely below 1), the non-finite ones equal."""
    k, p = k.double().cpu(), p.double().cpu()
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    assert torch.equal(k[~fin & ~torch.isnan(p)], p[~fin & ~torch.isnan(p)])
    if fin.any():
        err = ((k[fin] - p[fin]).abs() / p[fin].abs().clamp_min(1.0)).max()
        assert err.item() <= rtol, err.item()


def _kernels_launched(fn, reps=3):
    """(name, count) of every device record (kernels and copies) of
    ``reps`` calls of fn, by torch.profiler.  The profiler drops a trace's first device records, more as the
    process ages, so spin kernels (``torch.cuda._sleep``) go first and
    take the loss, four times as many again until one of them is left
    (as ``chip_smoke.profile_call`` does)."""
    from torch.profiler import ProfilerActivity, profile

    for lead in (256, 1024, 4096, 16384):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        if any("spin_kernel" in key for key, _ in seen):
            return [(k, c) for k, c in seen if "spin_kernel" not in k]
    raise AssertionError("the profiler lost every lead-in record")


def _builtin_args(ctx, name, dt, rng, n=N):
    """Vectors for one builtin of the sweep: floats of dt over its
    domain; integers (i32 for f32, i64 for f64; i16 and i32 for
    ``upsample``, which widens them) for the integer helpers; an i32
    exponent for ``ldexp``."""
    k = vex.BUILTINS[name].nargs
    if name in BUILTIN_INTEGER:
        npdt = np.int32 if dt == torch.float32 else np.int64
        if name == "upsample":
            npdt = np.int16 if dt == torch.float32 else np.int32
        return [vex.vector(data=rng.integers(-1000, 1000, n).astype(npdt),
                           context=ctx) for _ in range(k)]
    lo, hi = BUILTIN_DOMAIN.get(name, (-3, 3))
    npdt = np.float64 if dt == torch.float64 else np.float32
    args = [vex.vector(data=(lo + (hi - lo) * rng.random(n)).astype(npdt),
                       context=ctx) for _ in range(k)]
    if name == "ldexp":
        args[1] = vex.vector(data=rng.integers(-20, 20, n).astype(np.int32),
                             context=ctx)
    return args


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", KERNEL_BUILTINS)
def test_builtin_kernel_matches_plain(gpu, name, dt):
    fn = vex.BUILTINS[name]
    args = _builtin_args(gpu, name, dt, np.random.default_rng(1))
    expr = vex.as_expr(fn(*args))
    res_dt = vex.eval(expr).dtype
    k, p = _both(expr, N, res_dt, gpu.device)
    if not res_dt.is_floating_point:
        assert torch.equal(k, p)
    else:
        _close_each(k, p, 4 * RTOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_expression_and_compound_kernels(gpu, dt):
    rng = np.random.default_rng(2)
    npdt = np.float64 if dt == torch.float64 else np.float32
    a, b, c, d = (_vec(gpu, rng.standard_normal(N).astype(npdt))
                  for _ in range(4))
    k, p = _both(2 * b + vex.sin(c), N, dt, gpu.device)
    _close(k, p, RTOL[dt])
    ref = a.storage + (b.storage + c.storage * d.storage)
    a += b + c * d
    _close(a.storage, ref, RTOL[dt])
    # an f64 scalar keeps all its bits in an f64 expression
    x = _vec(gpu, np.zeros(N, npdt))
    x[:] = x + 0.1
    assert x[0] == (0.1 if dt == torch.float64 else float(np.float32(0.1)))
    x[:] = vex.if_else(b > 0, vex.cast(torch.int32, c * 10), d)
    e = torch.where(b.storage > 0, (c.storage * 10).to(torch.int32).to(dt),
                    d.storage)
    _close(x.storage, e, RTOL[dt])
    x[:] = vex.element_index() * 0.5 + vex.constants.pi()
    _close(x.storage, torch.arange(N, device=gpu.device, dtype=dt) * 0.5
           + np.pi, RTOL[dt])


def test_scalar_leaves_keep_their_values(gpu):
    """Scalars cross into the kernel in their own type: f64 values as
    their bits (0.0 and negatives included), numpy f32, ints, bools."""
    x = _vec(gpu, np.arange(N, dtype=np.float64))
    for s in (0.0, -0.0, -2.5, 1e-310, 1e300, np.float32(0.1), 3, -7,
              2 ** 40, True):
        k, p = _both(x * 0 + s, N, torch.float64, gpu.device)
        assert torch.equal(k, p), s
    i = _vec(gpu, np.arange(N, dtype=np.int32) - N // 2)
    for s in (0, 1, -1, 2 ** 20):
        k, p = _both(i * s + 1, N, torch.int32, gpu.device)
        assert torch.equal(k, p), s


def test_integer_floor_semantics_kernel(gpu):
    rng = np.random.default_rng(3)
    a = _vec(gpu, rng.integers(-50, 50, N).astype(np.int32))
    b = _vec(gpu, rng.choice([-7, -3, 2, 5], N).astype(np.int32))
    for e in (a // b, a % b, a // -3, a % 4, -a % b):
        k, p = _both(e, N, torch.int32, gpu.device)
        assert torch.equal(k, p)
    f = _vec(gpu, rng.standard_normal(N) * 10)
    g = _vec(gpu, rng.choice([-2.5, 1.5, 3.0], N))
    for e in (f // g, f % g):
        k, p = _both(e, N, torch.float64, gpu.device)
        _close(k, p, 1e-12)


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


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float32),
                                  (torch.float32, torch.float32),
                                  (torch.float64, torch.float64)])
@pytest.mark.parametrize("offs", [(-1, 0, 1), (-4096, -64, -1, 0, 1, 64, 4096),
                                  (3, 7), ()])
@pytest.mark.parametrize("nm", [(1 << 17, 1 << 17), (5000, 7000),
                                (7000, 5000)])
def test_dia_kernel_matches_plain(gpu, pair, offs, nm):
    n, m = nm
    vdt, xdt = pair
    g = torch.Generator().manual_seed(5)
    vals = torch.randint(-4, 5, (len(offs), n), generator=g).to(vdt)
    x = torch.randint(-4, 5, (m,), generator=g).to(xdt)
    # plane entries outside the matrix hold NaN: they must never be read
    i = torch.arange(n)
    for k, o in enumerate(offs):
        vals[k, (i + o < 0) | (i + o >= m)] = float("nan")
    vals, x = vals.to(gpu.device), x.to(gpu.device)
    offd = torch.tensor(offs, dtype=torch.int64, device=gpu.device)
    k = dia_matvec(n, m, offs, offd, vals, x)
    p = dia_matvec_plain(n, m, offs, vals, x)
    torch.cuda.synchronize()
    assert k.dtype == p.dtype and torch.equal(k, p)


def test_spmv_in_expression_and_in_place(gpu):
    from vexcl_tpu_torch.utils.poisson import poisson_7pt

    n = 24
    ptr, col, val = poisson_7pt(n, dtype=np.float32)
    A = vex.SpMat(n ** 3, n ** 3, ptr, col, val, context=gpu)
    assert A.device.vals.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    hx = rng.random(n ** 3).astype(np.float32)
    x = _vec(gpu, hx)
    y = _vec(gpu, hx)
    ref = dia_matvec_plain(A.n, A.m, A.device.offsets, A.device.vals,
                           x.storage)
    y[:] = 0.5 * (A * x) + y
    _close(y.storage, 0.5 * ref + x.storage, 2e-6)
    x[:] = A * x                      # in place: SpMV first, then the write
    _close(x.storage, ref, 2e-6)
    Sum = vex.Reductor(vex.SUM)
    s = Sum(y * (A * y))
    p = (y.storage * dia_matvec_plain(A.n, A.m, A.device.offsets,
                                      A.device.vals, y.storage)).sum().item()
    assert abs(s - p) <= 1e-5 * abs(p)


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


def _stencil_case(gpu, n, width, center, xdt, cdt, seed):
    from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_plain

    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, generator=g, dtype=torch.float64).to(xdt).to(gpu.device)
    c = (torch.rand(width, generator=g, dtype=torch.float64) - 0.5).to(cdt)
    c = c.to(gpu.device)
    k = stencil_apply(x, c, center)
    p = stencil_plain(x, c, center)
    torch.cuda.synchronize()
    assert k.dtype == p.dtype == vex.promote(xdt, cdt)
    return k, p


@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.float64, torch.float64),
                                  (torch.float32, torch.float64),
                                  (torch.float64, torch.float32)])
@pytest.mark.parametrize("shape", [(N, 5, 2), (N, 3, 0), (N, 3, 2),
                                   (N, 255, 40), (1 << 20, 129, 64),
                                   (1000, 7, 6), (3, 5, 2), (1, 4, 1),
                                   (N, 6000, 1234), (700, 6000, 5999)])
def test_stencil_kernel_matches_plain(gpu, pair, shape):
    """Tile kernel and, for 6000 taps, the L2 kernel; n < width too."""
    n, width, center = shape
    k, p = _stencil_case(gpu, n, width, center, *pair, seed=width + n)
    tol = RTOL[k.dtype] * max(1, width // 8)
    _close(k, p, tol)


def test_stencil_api_in_place_and_operator(gpu):
    from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_plain

    rng = np.random.default_rng(41)
    hx = rng.random(N).astype(np.float32)
    x = _vec(gpu, hx)
    y = vex.vector(N, dtype=torch.float32, context=gpu)
    s = vex.stencil(np.asarray([0.1, 0.2, 0.4, 0.2, 0.1], np.float32), 2)
    ref = stencil_plain(x.storage.clone(), s.coeff_on(gpu.device), 2)
    before = stencil_apply.launches
    y[:] = x * s
    _close(y.storage, ref, RTOL[torch.float32])
    x[:] = x * s                      # in place: reads the old x
    _close(x.storage, ref, RTOL[torch.float32])
    assert stencil_apply.launches == before + 2
    op = vex.StencilOperator(3, 1, lambda X: X[0] + (X[-1] + X[1]) ** 3)
    x = _vec(gpu, hx)
    y[:] = op(x)
    t = torch.from_numpy(hx).double()
    tp = torch.cat([t[:1], t, t[-1:]])
    _close(y.storage, tp[1:-1] + (tp[:-2] + tp[2:]) ** 3, 4e-6)


def test_stencil_uncovered_pair_raises(gpu):
    from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply

    x = torch.ones(100, dtype=torch.int32, device=gpu.device)
    with pytest.raises(NotImplementedError):
        stencil_apply(x, torch.ones(3, dtype=torch.float32,
                                    device=gpu.device), 1)
    with pytest.raises(NotImplementedError):
        stencil_apply(x.float(), torch.ones(3, dtype=torch.float16,
                                            device=gpu.device), 1)


def _irregular(n, m, seed, long_rows=(), integer=False):
    rng = np.random.default_rng(seed)
    lens = rng.poisson(6, n)
    lens[::9] = 0                                  # empty rows
    for r in long_rows:
        lens[r] = 700                              # above the spill length
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, m, int(ptr[-1]))
    col[1::13] = col[0::13][:len(col[1::13])]      # some duplicates
    val = (rng.integers(-4, 5, int(ptr[-1])).astype(np.float64) if integer
           else rng.standard_normal(int(ptr[-1])))
    return ptr, col, val


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("fmt", ["csr", "ell", "hyb", "sellr"])
@pytest.mark.parametrize("nm", [(5000, 5000), (3000, 7000), (7000, 300),
                                (33, 33), (40000, 40000)])
def test_sparse_kernels_match_plain(gpu, fmt, dt, nm):
    """Each format's kernels against their plain versions on the same
    stored arrays, on integer-valued data (exact in any order): empty
    rows, duplicates, rectangular, rows above the SELL spill length."""
    from vexcl_tpu_torch.sparse.cuda_sell import (csr_spmv, csr_spmv_plain,
                                                  sell_spmv, sell_spmv_plain)
    from vexcl_tpu_torch.sparse.formats import from_csr_host

    n, m = nm
    ptr, col, val = _irregular(n, m, n + m, long_rows=(1, n // 2),
                               integer=True)
    npdt = np.float64 if dt == torch.float64 else np.float32
    A = from_csr_host(n, m, ptr, col, val.astype(npdt), fmt,
                      device=gpu.device)
    x = torch.from_numpy(np.random.default_rng(7).integers(-3, 4, m)
                         .astype(npdt)).to(gpu.device)
    before = (sell_spmv.launches, csr_spmv.launches)
    k = A.apply(x)
    if fmt == "csr":
        p = csr_spmv_plain(n, A.ptr, A.col, A.val, x)
    else:
        p = sell_spmv_plain(n, A.slice_ptr, A.col, A.val, A.perm, x)
        if A.tail is not None:
            t = A.tail
            csr_spmv_plain(n, t.ptr, t.col, t.val, x, t.rows, out=p)
    torch.cuda.synchronize()
    assert k.dtype == p.dtype == dt and torch.equal(k, p)
    import scipy.sparse as sp
    ref = sp.csr_matrix((val, col, ptr), shape=(n, m)) @ x.double().cpu().numpy()
    assert np.array_equal(k.double().cpu().numpy(), ref)
    launched = (sell_spmv.launches - before[0], csr_spmv.launches - before[1])
    want_tail = fmt == "csr" or getattr(A, "tail", None) is not None
    assert launched == (int(fmt != "csr"), int(want_tail))
    if fmt == "sellr":
        assert A.tail is not None              # the 700-entry rows spilled


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["empty_rows", "row_100k", "one_block", "n1",
                                  "n1_empty", "medium_rows", "hyb_tail",
                                  "sellr_tail", "lognormal"])
def test_csr_row_blocks_match_plain(gpu, case, dt):
    """The row-block CSR kernel against its plain version: integer data
    (exact in any order) for the shapes of the plan, random values within
    the SpMV tolerance for the tails (``rows`` + ``out``) and the bench's
    lognormal row lengths."""
    from vexcl_tpu_torch.sparse.cuda_sell import csr_spmv, csr_spmv_plain
    from vexcl_tpu_torch.sparse.formats import from_csr_host

    rng = np.random.default_rng(16)
    npdt = np.float64 if dt == torch.float64 else np.float32
    m = 5000
    lens = {"empty_rows": rng.poisson(6, 20000) * (np.arange(20000) % 9 > 0),
            "row_100k": np.r_[rng.poisson(6, 1500), 100000,
                              rng.poisson(6, 1500)],
            "one_block": rng.poisson(5, 100), "n1": [7], "n1_empty": [0],
            "medium_rows": rng.integers(0, 1500, 3000),
            "lognormal": np.maximum(1, rng.lognormal(np.log(16) - 0.32, 0.8,
                                                     50000).astype(int))
            }.get(case, rng.poisson(8, 20000))
    lens = np.asarray(lens, np.int64)
    if case.endswith("tail"):
        lens[[3, 700, 701]] = [300, 3000, 9000]   # past SELL's spill length
    n = len(lens)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, m, int(ptr[-1]))
    exact = case not in ("hyb_tail", "sellr_tail", "lognormal")
    val = (rng.integers(-4, 5, int(ptr[-1])) if exact
           else rng.standard_normal(int(ptr[-1]))).astype(npdt)
    x = torch.from_numpy((rng.integers(-3, 4, m) if exact
                          else rng.standard_normal(m)).astype(npdt))
    x = x.to(gpu.device)
    fmt = case[:-5] if case.endswith("tail") else "csr"
    A = from_csr_host(n, m, ptr, col, val, fmt, device=gpu.device)
    T = A if fmt == "csr" else A.tail
    base = None if fmt == "csr" else torch.from_numpy(
        rng.standard_normal(n).astype(npdt)).to(gpu.device)
    before = csr_spmv.launches
    k = csr_spmv(n, T.ptr, T.col, T.val, x, T.rows,
                 None if base is None else base.clone(), T.blocks)
    p = csr_spmv_plain(n, T.ptr, T.col, T.val, x, T.rows,
                       None if base is None else base.clone())
    torch.cuda.synchronize()
    assert csr_spmv.launches == before + 1
    assert torch.equal(csr_spmv(n, T.ptr, T.col, T.val, x, T.rows,
                                None if base is None else base.clone(),
                                T.blocks), k)          # deterministic
    if exact:
        assert k.dtype == p.dtype == dt and torch.equal(k, p)
    else:
        _close(k, p, 1e-5 if dt == torch.float32 else 1e-12)
        _close(A.apply(x), csr_spmv_plain(n, A.ptr, A.col, A.val, x)
               if fmt == "csr" else _csr_plain_full(n, ptr, col, val, x),
               1e-5 if dt == torch.float32 else 1e-12)


def _exact_sparse(n, m, lens, seed):
    """CSR arrays of integer values (exact in any summation order)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    col = rng.integers(0, max(m, 1), int(ptr[-1]))
    val = rng.integers(-4, 5, int(ptr[-1])).astype(np.float64)
    return ptr, col, val


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["ell_w5", "ell_w7", "hyb_w6", "sellr_n33",
                                  "sellr_n1", "empty", "no_rows", "spill",
                                  "spill_all"])
def test_sell_packet_shapes_match_plain(gpu, case, dt):
    """The SELL kernel's packet layout at the shapes where it pads: widths
    not a multiple of 4 (ELL, the hybrid's ELL part), n not a multiple of
    32, an empty matrix, no rows, SELLR with rows just under, at, over and
    three times ``LONG_ROW``, and SELLR with every row spilled.  Integer
    data: exact against the plain version and scipy."""
    import scipy.sparse as sp

    from vexcl_tpu_torch.sparse import ELL, SELLR, Hybrid
    from vexcl_tpu_torch.sparse.cuda_sell import (csr_spmv_plain, sell_spmv,
                                                  sell_spmv_plain)
    from vexcl_tpu_torch.sparse.sell import LONG_ROW

    rng = np.random.default_rng(17)
    npdt = np.float64 if dt == torch.float64 else np.float32
    m = 3001
    if case == "ell_w5":
        n, lens, cls = 1000, rng.integers(0, 6, 1000), ELL
    elif case == "ell_w7":
        n, lens, cls = 77, rng.integers(0, 8, 77), ELL
    elif case == "hyb_w6":
        n, lens, cls = 5000, rng.poisson(6, 5000), Hybrid
    elif case.startswith("sellr"):
        n = int(case[7:])
        lens, cls = rng.poisson(9, n), SELLR
    elif case in ("empty", "no_rows"):
        n = 500 if case == "empty" else 0
        lens, cls = np.zeros(n, np.int64), SELLR
    elif case == "spill":
        n, cls = 20000, SELLR
        lens = np.maximum(1, rng.lognormal(np.log(16) - 0.32, 0.8, n)
                          .astype(np.int64))
        lens[[5, 6, 7, 8]] = [LONG_ROW - 1, LONG_ROW, LONG_ROW + 1,
                              3 * LONG_ROW]
    else:
        n, cls = 300, SELLR
        lens = rng.integers(LONG_ROW + 1, 2 * LONG_ROW, n)
    ptr, col, val = _exact_sparse(n, m, lens, 18)
    mats = [cls(n, m, ptr, col, val.astype(npdt), device=gpu.device)]
    if cls is SELLR and case in ("empty", "no_rows"):
        mats += [c(n, m, ptr, col, val.astype(npdt), device=gpu.device)
                 for c in (ELL, Hybrid)]
    x = torch.from_numpy(rng.integers(-3, 4, m).astype(npdt)).to(gpu.device)
    want = sp.csr_matrix((val, col, ptr), shape=(n, m)) @ \
        x.double().cpu().numpy()
    for A in mats:
        assert A.slots % (4 * 32) == 0
        assert torch.all(A.slice_ptr % 4 == 0)
        k = sell_spmv(n, A.slice_ptr, A.col, A.val, A.perm, x)
        p = sell_spmv_plain(n, A.slice_ptr, A.col, A.val, A.perm, x)
        torch.cuda.synchronize()
        assert k.dtype == p.dtype == dt and torch.equal(k, p)
        y = A.apply(x)
        assert np.array_equal(y.double().cpu().numpy(), want)
        if A.tail is not None:
            T = A.tail
            p = csr_spmv_plain(n, T.ptr, T.col, T.val, x, T.rows, out=p)
            assert torch.equal(y, p)
    if case.startswith("spill"):
        spilled = mats[0].tail.rows.tolist()
        assert spilled == np.flatnonzero(lens > LONG_ROW).tolist()
    if case == "spill":
        assert 7 in spilled and 8 in spilled and 6 not in spilled
    elif case == "spill_all":
        assert len(spilled) == n


def test_sell_rejects_unaligned_planes(gpu):
    """The kernel loads 16-byte packets: planes that are views off a
    16-byte boundary raise instead of faulting."""
    from vexcl_tpu_torch.sparse import SELLR
    from vexcl_tpu_torch.sparse.cuda_sell import sell_spmv

    n = 64
    ptr, col, val = _exact_sparse(n, n, np.full(n, 3), 19)
    A = SELLR(n, n, ptr, col, val.astype(np.float32), device=gpu.device)
    x = torch.ones(n, device=gpu.device)
    colv = torch.cat([A.col.new_zeros(1), A.col])[1:]
    with pytest.raises(ValueError, match="aligned"):
        sell_spmv(n, A.slice_ptr, colv, A.val, A.perm, x)


def _csr_plain_full(n, ptr, col, val, x):
    from vexcl_tpu_torch.sparse.cuda_sell import csr_spmv_plain

    dev = x.device
    return csr_spmv_plain(n, torch.from_numpy(ptr).to(dev),
                          torch.from_numpy(col.astype(np.int32)).to(dev),
                          torch.from_numpy(val).to(dev), x)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_sparse_kernels_random_values(gpu, dt):
    n = 20000
    ptr, col, val = _irregular(n, n, 3, long_rows=(5,))
    npdt = np.float64 if dt == torch.float64 else np.float32
    x = np.random.default_rng(8).standard_normal(n).astype(npdt)
    ctx = gpu
    X = vex.vector(data=x, context=ctx)
    results = {}
    for fmt in ("csr", "ell", "hyb", "sellr"):
        A = vex.SpMat(n, n, ptr, col, val.astype(npdt), fmt=fmt, context=ctx)
        Y = vex.vector(data=x, context=ctx)
        Y[:] = 2 * (A * X) + Y
        results[fmt] = Y.storage
    for fmt in ("ell", "hyb", "sellr"):
        _close(results[fmt], results["csr"], 1e-5 if dt == torch.float32
               else 1e-12)


def test_spmat_default_format_and_in_place(gpu):
    from vexcl_tpu_torch.utils.poisson import poisson_7pt

    n = 4000
    ptr, col, val = _irregular(n, n, 4)
    A = vex.SpMat(n, n, ptr, col, val.astype(np.float32), context=gpu)
    assert A.device.format == "csr"
    P = vex.SpMat(512, 512, *poisson_7pt(8), context=gpu)
    assert P.device.format == "dia"
    hx = np.random.default_rng(9).random(n).astype(np.float32)
    x = _vec(gpu, hx)
    ref = A.device.apply(x.storage.clone())
    x[:] = A * x                      # in place: SpMV first, then the write
    _close(x.storage, ref, 0)


def test_sparse_uncovered_pairs_raise(gpu):
    n = 100
    ptr, col, val = _irregular(n, n, 5)
    for fmt in ("csr", "sellr"):
        A = vex.SpMat(n, n, ptr, col, val.astype(np.float32), fmt=fmt,
                      context=gpu)
        with pytest.raises(NotImplementedError):
            A.device.apply(torch.ones(n, dtype=torch.float64,
                                      device=gpu.device))
        B = vex.SpMat(n, n, ptr, col, val.astype(np.int32), fmt=fmt,
                      context=gpu)
        with pytest.raises(NotImplementedError):
            B.device.apply(torch.ones(n, dtype=torch.int32,
                                      device=gpu.device))
    from vexcl_tpu_torch.sparse.cuda_sell import csr_spmv
    from vexcl_tpu_torch.sparse.formats import CSR

    D = CSR(n, n, ptr, col, val.astype(np.float32), device=gpu.device)
    with pytest.raises(ValueError, match="row blocks"):   # the plan
        csr_spmv(n, D.ptr, D.col, D.val, torch.ones(n, device=gpu.device))


@pytest.mark.parametrize("cache", [None, False])
def test_ccsr_kernel_path_matches_plain(gpu, cache):
    from vexcl_tpu_torch.utils.poisson import poisson_7pt_ccsr

    m = 24
    idx, row, col, val = poisson_7pt_ccsr(m, dtype=np.float32)
    A = vex.SpMatCCSR(m ** 3, m ** 3, idx, row, col, val, context=gpu,
                      cache_expansion=cache)
    assert (A.cached_coeffs is not None) == (cache is None)
    if cache is None:
        assert A.cached_coeffs.dtype == torch.bfloat16
    hx = np.random.default_rng(10).random(m ** 3).astype(np.float32)
    x = _vec(gpu, hx)
    before = dia_matvec.launches
    y = vex.vector(m ** 3, context=gpu)
    y[:] = A * x
    assert dia_matvec.launches == before + 1
    coeffs = A._expand()
    ref = dia_matvec_plain(A.n, A.m, A.offset_union, coeffs, x.storage)
    _close(y.storage, ref, 2e-6)


WINDOWS3 = "3 windows + 77"
SCAN_N = (1, 31, 4097, (1 << 20) + 3, WINDOWS3)
SCAN_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
              torch.bfloat16)
SCAN_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}


def _scan_geometry(dt):
    """(elements a tile of ``dt``, tiles a look-back window) of the scan
    kernel."""
    from vexcl_tpu_torch.ops.cuda_scan import _DTYPE_CODE, _lib

    lib = _lib()
    return lib.tiles[_DTYPE_CODE[dt]], lib.window


def _scan_n(n, dt):
    """A size of SCAN_N for ``dt``: WINDOWS3 crosses three look-back
    windows of the kernel's own tile and window and ends in a ragged
    tile."""
    if n != WINDOWS3:
        return n
    tile, window = _scan_geometry(dt)
    return 3 * window * tile + 77


def _scan_data(n, dt, seed):
    g = torch.Generator().manual_seed(seed)
    if dt.is_floating_point:
        x = torch.rand(n, generator=g, dtype=torch.float64) - 0.25
    else:
        x = torch.randint(-1000, 1000, (n,), generator=g)
    return x.to(dt)


def _scan_close(k, p, mono):
    assert k.dtype == p.dtype and k.shape == p.shape
    if mono != "add" or not k.dtype.is_floating_point:
        kn, pn = torch.isnan(k), torch.isnan(p)
        assert torch.equal(kn, pn) and torch.equal(k[~kn], p[~pn])
        return
    _close(k, p, SCAN_TOL[k.dtype])


@pytest.mark.parametrize("n", SCAN_N)
@pytest.mark.parametrize("dt", SCAN_TYPES)
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_scan_kernel_matches_plain(gpu, mono, dt, n):
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, scan_plain

    n = _scan_n(n, dt)
    x = _scan_data(n, dt, n).to(gpu.device)
    before = scan_apply.launches
    k = scan_apply(x, mono)
    p = scan_plain(x, mono)
    torch.cuda.synchronize()
    assert scan_apply.launches == before + 1
    _scan_close(k, p, mono)
    # deterministic: the same input gives the same bits
    assert torch.equal(scan_apply(x, mono), k)
    # in place: y is x
    y = x.clone()
    assert scan_apply(y, mono, out=y) is y
    torch.cuda.synchronize()
    assert torch.equal(y, k)


@pytest.mark.parametrize("n", SCAN_N)
@pytest.mark.parametrize("dt", SCAN_TYPES)
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_segscan_kernel_matches_plain(gpu, mono, dt, n):
    from vexcl_tpu_torch.ops.cuda_scan import segscan_apply, segscan_plain

    n = _scan_n(n, dt)
    x = _scan_data(n, dt, n + 1).to(gpu.device)
    g = torch.Generator().manual_seed(n + 2)
    for p_head in (0.0, 0.01, 0.5, 1.0):
        heads = (torch.rand(n, generator=g) < p_head).to(torch.uint8)
        heads = heads.to(gpu.device)
        before = segscan_apply.launches
        k = segscan_apply(heads, x, mono)
        p = segscan_plain(heads, x, mono)
        torch.cuda.synchronize()
        assert segscan_apply.launches == before + 1
        _scan_close(k, p, mono)
        assert torch.equal(segscan_apply(heads.bool(), x, mono), k)
        y = x.clone()
        segscan_apply(heads, y, mono, out=y)
        torch.cuda.synchronize()
        assert torch.equal(y, k)


@pytest.mark.parametrize("n", [31, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.bfloat16])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_kernels_propagate_nan(gpu, mono, dt, n):
    from vexcl_tpu_torch.ops.cuda_scan import (scan_apply, scan_plain,
                                               segscan_apply, segscan_plain)

    x = _scan_data(n, dt, 5).to(gpu.device)
    x[n // 2] = float("nan")
    k = scan_apply(x, mono)
    assert torch.isnan(k[n // 2:]).all() and not torch.isnan(k[:n // 2]).any()
    _scan_close(k, scan_plain(x, mono), mono)
    heads = torch.zeros(n, dtype=torch.uint8, device=gpu.device)
    heads[0] = 1
    heads[min(n - 1, n // 2 + 3)] = 1
    k = segscan_apply(heads, x, mono)
    _scan_close(k, segscan_plain(heads, x, mono), mono)


@pytest.mark.parametrize("where", ["tile_starts", "tile_ends",
                                   "window_starts"])
@pytest.mark.parametrize("dt", SCAN_TYPES)
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_segscan_heads_on_tile_and_window_edges(gpu, mono, dt, where):
    """Heads at every tile start, every tile end and every window start of
    the kernel, over three windows and a ragged tail: the (flag, value)
    carry across tiles and windows, and the same bits twice."""
    from vexcl_tpu_torch.ops.cuda_scan import segscan_apply, segscan_plain

    tile, window = _scan_geometry(dt)
    n = _scan_n(WINDOWS3, dt)
    dev = gpu.device
    x = _scan_data(n, dt, 7).to(dev)
    pos = torch.arange(n, device=dev)
    period = tile * window if where == "window_starts" else tile
    heads = (pos % period == (period - 1 if where == "tile_ends" else 0))
    heads = heads.to(torch.uint8)
    k = segscan_apply(heads, x, mono)
    _scan_close(k, segscan_plain(heads, x, mono), mono)
    assert torch.equal(segscan_apply(heads, x, mono), k)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.bfloat16])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_nan_in_an_earlier_window(gpu, mono, dt, segmented):
    """A NaN in the first window reaches every later window through the
    window prefixes (segmented: up to the next head, in the third)."""
    from vexcl_tpu_torch.ops.cuda_scan import (scan_apply, scan_plain,
                                               segscan_apply, segscan_plain)

    tile, window = _scan_geometry(dt)
    n = _scan_n(WINDOWS3, dt)
    dev = gpu.device
    x = _scan_data(n, dt, 9).to(dev)
    inan, stop = 5 * tile + 3, 2 * window * tile + 100
    x[inan] = float("nan")
    if segmented:
        heads = torch.zeros(n, dtype=torch.uint8, device=dev)
        heads[[0, stop]] = 1
        k, p = segscan_apply(heads, x, mono), segscan_plain(heads, x, mono)
    else:
        stop = n
        k, p = scan_apply(x, mono), scan_plain(x, mono)
    assert torch.isnan(k[inan:stop]).all()
    assert not torch.isnan(k[:inan]).any() and not torch.isnan(k[stop:]).any()
    _scan_close(k, p, mono)


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 0), (1, 1, 1),
                                     (3, 5, 1), (0, 0, 1)])
@pytest.mark.parametrize("dt", SCAN_TYPES)
def test_scans_on_unaligned_views(gpu, dt, offsets):
    """x[a:], heads[b:] and out[c:] at element offsets (a, b, c), none or
    some 16-byte aligned, over three windows: the kernel reads and writes
    the unaligned ends itself; in place on the view gives the same bits."""
    from vexcl_tpu_torch.ops.cuda_scan import (scan_apply, scan_plain,
                                               segscan_apply, segscan_plain)

    xo, ho, oo = offsets
    n = _scan_n(WINDOWS3, dt)
    dev = gpu.device
    g = torch.Generator(device=dev).manual_seed(12)
    xbuf = _scan_data(n + xo, dt, 11).to(dev)
    x = xbuf[xo:]
    heads = (torch.rand(n + ho, generator=g, device=dev) < 0.01)
    heads = heads.to(torch.uint8)[ho:]
    out = torch.empty(n + oo, dtype=dt, device=dev)[oo:]
    assert x.is_contiguous() and heads.is_contiguous() and out.is_contiguous()
    for mono in ("add", "max", "min"):
        for seg in (False, True):
            if seg:
                k = segscan_apply(heads, x, mono, out=out)
                p = segscan_plain(heads, x, mono)
            else:
                k = scan_apply(x, mono, out=out)
                p = scan_plain(x, mono)
            assert k is out
            _scan_close(k, p, mono)
            ybuf = xbuf.clone()
            y = ybuf[xo:]
            if seg:
                segscan_apply(heads, y, mono, out=y)
            else:
                scan_apply(y, mono, out=y)
            assert torch.equal(y, k) and torch.equal(ybuf[:xo], xbuf[:xo])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_scans_over_many_calls(gpu, dt):
    """Fifty plain and fifty segmented float sums in a row over three
    windows, each bitwise the first: every launch leaves the scratch reset,
    and the window order does not depend on timing."""
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply

    n = _scan_n(WINDOWS3, dt)
    dev = gpu.device
    x = _scan_data(n, dt, 13).to(dev)
    heads = (torch.arange(n, device=dev) % 5000 == 17).to(torch.uint8)
    s0, g0 = scan_apply(x), segscan_apply(heads, x)
    same = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(50):
        same &= torch.equal(scan_apply(x), s0)
        same &= torch.equal(segscan_apply(heads, x), g0)
    assert same.item()


def test_scans_on_two_streams(gpu):
    """Scans enqueued on two streams at once each get their own status
    words and tickets: every result is right."""
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply

    dev = gpu.device
    n = _scan_n(WINDOWS3, torch.float64)
    xs = [_scan_data(n, torch.float64, s).to(dev) for s in (14, 15)]
    heads = (torch.arange(n, device=dev) % 777 == 0).to(torch.uint8)
    want = [(scan_apply(x), segscan_apply(heads, x)) for x in xs]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    res = []
    for _ in range(20):
        for s, x, w in zip((s1, s2), xs, want):
            with torch.cuda.stream(s):
                res.append((w, scan_apply(x), segscan_apply(heads, x)))
    torch.cuda.synchronize()
    for (ws, wg), ks, kg in res:
        assert torch.equal(ks, ws) and torch.equal(kg, wg)


def test_scan_scratch_is_bounded(gpu, monkeypatch):
    """More streams than the cache keeps, in turns: the oldest scratch is
    freed, a stream that comes back gets a new one, and every result is
    right."""
    from vexcl_tpu_torch.ops import cuda_scan
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply

    monkeypatch.setattr(cuda_scan._scratch, "max_streams", 2)
    dev = gpu.device
    n = (1 << 22) + 9
    x = _scan_data(n, torch.float32, 16).to(dev)
    heads = (torch.arange(n, device=dev) % 300 == 0).to(torch.uint8)
    want = (scan_apply(x), segscan_apply(heads, x))
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                res.append((scan_apply(x), segscan_apply(heads, x)))
    torch.cuda.synchronize()
    assert len(cuda_scan._scratch.entries) <= 2
    for a, b in res:
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])


@pytest.mark.parametrize("dt", SCAN_TYPES)
def test_scans_are_one_kernel_launch(gpu, dt):
    """A call is one kernel on the card, for every monoid: no fill, no
    second pass."""
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply

    dev = gpu.device
    n = 1 << 20
    x = _scan_data(n, dt, 17).to(dev)
    heads = (torch.arange(n, device=dev) % 64 == 0).to(torch.uint8)
    calls = {"scan": lambda m: scan_apply(x, m),
             "segscan": lambda m: segscan_apply(heads, x, m)}
    for name, fn in calls.items():
        for mono in ("add", "max", "min"):
            fn(mono)                      # the scratch, at first use
            kernels = _kernels_launched(lambda: fn(mono))
            assert len(kernels) == 1 and "scan_kernel" in kernels[0][0], (
                name, mono, kernels)
            assert kernels[0][1] == 3


@pytest.mark.parametrize("n", [1, 31, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("p_flag", [0.0, 0.02, 0.5, 1.0])
def test_compact_kernel_matches_plain(gpu, n, p_flag):
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply, compact_plain

    g = torch.Generator().manual_seed(n)
    flags = (torch.rand(n, generator=g) < p_flag).to(torch.uint8)
    payloads = [torch.rand(n, generator=g), torch.arange(n),
                torch.randint(-9, 9, (n,), generator=g).to(torch.int16),
                torch.rand(n, generator=g) < 0.5,
                torch.rand(n, generator=g, dtype=torch.float64)]
    flags = flags.to(gpu.device)
    payloads = [p.to(gpu.device) for p in payloads]
    before = compact_apply.launches
    kc, *k = compact_apply(flags, *payloads)
    pc, *p = compact_plain(flags, *payloads)
    torch.cuda.synchronize()
    assert compact_apply.launches == before + 1
    m = int(pc)
    assert int(kc) == m == int(flags.sum())
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a[:m], b[:m])
    kc, *k2 = compact_apply(flags.bool(), *payloads)
    assert all(torch.equal(a[:m], b[:m]) for a, b in zip(k2, k))


def test_compact_kernel_rejects_what_it_cannot_move(gpu):
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply

    f = torch.ones(10, dtype=torch.uint8, device=gpu.device)
    with pytest.raises(NotImplementedError):
        compact_apply(f, torch.ones(10, dtype=torch.complex128,
                                    device=gpu.device))
    with pytest.raises(NotImplementedError):
        compact_apply(f.int(), torch.ones(10, device=gpu.device))
    with pytest.raises(NotImplementedError):
        scan_apply(torch.ones(10, dtype=torch.float16, device=gpu.device))


COMPACT_N = (1, 15, 4096, 4097, (1 << 24) + 3)


def _mixed_payloads(n, g, dev):
    """Eight payloads of every width: 4, 8, 2, 1 (bool), 8, 1, 4, 2 bytes."""
    def ints(lo, hi, dt):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dt)
    return [torch.rand(n, generator=g, device=dev),
            ints(-2 ** 62, 2 ** 62, torch.int64),
            ints(-999, 999, torch.int16),
            torch.rand(n, generator=g, device=dev) < 0.5,
            torch.rand(n, generator=g, device=dev, dtype=torch.float64),
            ints(0, 256, torch.uint8),
            ints(-2 ** 31, 2 ** 31 - 1, torch.int32),
            torch.rand(n, generator=g, device=dev).to(torch.bfloat16)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("share", [0.0, 1 / 64, 0.5, 1.0])
@pytest.mark.parametrize("n", COMPACT_N)
def test_compact_single_pass_matches_plain(gpu, n, share, offset):
    """The single-pass kernel bitwise against the plain version: tiny n,
    n below and above one tile, 2^24 + 3; no, few, half and all flags
    set; eight payloads of mixed widths; a flags view at a 1-byte offset
    (not 16-byte aligned); three calls alike (the scratch is left reset),
    one launch each, bool flags alike."""
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply, compact_plain

    dev = gpu.device
    g = torch.Generator(device=dev).manual_seed(n + offset)
    buf = (torch.rand(n + offset, generator=g, device=dev) < share)
    flags = buf.to(torch.uint8)[offset:]
    assert flags.is_contiguous() and (flags.data_ptr() % 16 != 0) == (
        offset != 0)
    payloads = _mixed_payloads(n, g, dev)
    pc, *p = compact_plain(flags, *payloads)
    m = int(pc)
    before = compact_apply.launches
    runs = [compact_apply(flags, *payloads) for _ in range(3)]
    runs.append(compact_apply(buf[offset:], *payloads))     # bool flags
    torch.cuda.synchronize()
    assert compact_apply.launches == before + 4
    assert m == int(flags.sum())
    for kc, *k in runs:
        assert kc.dtype == torch.int64 and kc.shape == () and int(kc) == m
        for a, b in zip(k, p):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a[:m], b[:m])


@pytest.mark.parametrize("n, share", [((1 << 24) + 3, 0.5),
                                      ((1 << 25) + 7, 1 / 64)])
def test_compact_count_over_many_calls(gpu, n, share):
    """Fifty calls in a row, each count right: the last block reads the
    count before it clears the status words for the next call."""
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply

    dev = gpu.device
    g = torch.Generator(device=dev).manual_seed(22)
    flags = (torch.rand(n, generator=g, device=dev) < share).to(torch.uint8)
    x = torch.arange(n, device=dev, dtype=torch.int32)
    counts = torch.stack([compact_apply(flags, x)[0] for _ in range(50)])
    assert torch.all(counts == flags.sum()).item()


def test_compact_on_two_streams(gpu):
    """Compactions enqueued on two streams at once each get their own
    status words and tickets: every result is right."""
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply

    dev = gpu.device
    n = (1 << 22) + 5
    g = torch.Generator(device=dev).manual_seed(21)
    flags = [(torch.rand(n, generator=g, device=dev) < s).to(torch.uint8)
             for s in (0.3, 0.7)]
    a = torch.arange(n, device=dev)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    res = []
    for _ in range(20):
        for s, f in zip((s1, s2), flags):
            with torch.cuda.stream(s):
                res.append((f, compact_apply(f, a)))
    torch.cuda.synchronize()
    for f, (c, o) in res:
        m = int(f.sum())
        assert int(c) == m and torch.equal(o[:m], a[f.bool()])


def test_compact_scratch_is_bounded(gpu, monkeypatch):
    """More streams than the cache keeps, in turns: the oldest scratch is
    freed, a stream that comes back gets a new one, and every result is
    right."""
    from vexcl_tpu_torch.ops import cuda_compact
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply

    monkeypatch.setattr(cuda_compact._scratch, "max_streams", 2)
    dev = gpu.device
    n = (1 << 20) + 9
    g = torch.Generator(device=dev).manual_seed(23)
    flags = (torch.rand(n, generator=g, device=dev) < 0.4).to(torch.uint8)
    a = torch.arange(n, device=dev)
    want = a[flags.bool()]
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                res.append(compact_apply(flags, a))
    torch.cuda.synchronize()
    assert len(cuda_compact._scratch.entries) <= 2
    for c, o in res:
        assert int(c) == want.numel() and torch.equal(o[:want.numel()], want)


def test_compact_is_one_kernel_launch(gpu):
    """A call is one kernel on the card: no fill, no second pass."""
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply

    dev = gpu.device
    n = 1 << 20
    flags = (torch.arange(n, device=dev) % 64 == 0).to(torch.uint8)
    x = torch.rand(n, device=dev)
    compact_apply(flags, x, x)            # the scratch, at first use
    kernels = _kernels_launched(lambda: compact_apply(flags, x, x))
    assert len(kernels) == 1 and "compact_kernel" in kernels[0][0]
    assert kernels[0][1] == 3


# -- the keyed kernel (csrc/by_key.cuh): reduce_by_key and the keyed scans --

BY_KEY_MODES = [(False, None), (True, None), (False, 2), (True, 3)]
BY_KEY_N = ("1", "tile-1", "tile", "tile+1", "window*tile+1", (1 << 20) + 3)
_MONO_FN = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}


def _by_key_n(n, dt):
    """A size of BY_KEY_N for ``dt``, by the keyed kernel's own tile and
    window."""
    from vexcl_tpu_torch.ops.cuda_by_key import _lib
    from vexcl_tpu_torch.ops.cuda_scan import _DTYPE_CODE

    if not isinstance(n, str):
        return n
    code = _DTYPE_CODE[dt]
    tile, window = _lib(code).tiles[code], _lib(code).window
    return {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "window*tile+1": window * tile + 1}[n]


def _key_vectors(count, n, seed, dev, run=30):
    """``count`` key vectors of mixed widths over one sequence of runs
    (mean length ``run``): i32, i8, i16, i64, bool, f16, f64 in turn."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.sort(torch.randint(0, max(n // run, 1), (n,), generator=g,
                                    device=dev)).values
    forms = [base.to(torch.int32), (base % 7).to(torch.int8),
             (base // 2).to(torch.int16), base * 3, (base % 2).bool(),
             (base % 1000).to(torch.float16), base.double() * 0.5]
    return tuple(forms[:count])


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _aligned_like(x):
    """An empty tensor like x at x's offset from a 16-byte boundary (a
    scan's tiles start there: the same alignment, the same bits)."""
    per = 16 // x.element_size()
    buf = torch.empty(x.numel() + per, dtype=x.dtype, device=x.device)
    off = (x.data_ptr() - buf.data_ptr()) % 16 // x.element_size()
    return buf[off:off + x.numel()]


def _today_route(keys, x, mono):
    """The keyed results the route before the keyed kernel gave: head
    flags by tensor compares, segscan_apply, then compact_apply."""
    from vexcl_tpu_torch.ops.cuda_by_key import segment_heads
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply
    from vexcl_tpu_torch.ops.cuda_scan import segscan_apply

    heads = segment_heads(keys)
    incl = segscan_apply(heads.to(torch.uint8), x, mono)
    tails = torch.cat([heads[1:], heads.new_ones(1)])
    count, totals, *tail_keys = compact_apply(tails, incl, *keys)
    m = int(count)
    return heads, incl, m, totals[:m], [k[:m] for k in tail_keys]


def _check_by_key(keys, x, mono, out_view=None):
    """Both entries against today's route (bit for bit) and the plain
    versions (the scan tolerances), one launch a call, the same bits
    twice, in place; out_view, when given, receives the scan."""
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 reduce_by_key_launch,
                                                 reduce_by_key_plain,
                                                 scan_by_key_apply,
                                                 scan_by_key_epilogue,
                                                 scan_by_key_plain)

    heads, incl, m, totals, tail_keys = _today_route(keys, x, mono)
    for exclusive, init in BY_KEY_MODES:
        before = scan_by_key_apply.launches
        y = scan_by_key_apply(keys, x, mono, exclusive, init, out=out_view)
        torch.cuda.synchronize()
        assert scan_by_key_apply.launches == before + 1
        want = scan_by_key_epilogue(heads, incl, _MONO_FN[mono], exclusive,
                                    init)
        assert torch.equal(_bits(y), _bits(want)), (mono, exclusive, init)
        _scan_close(y, scan_by_key_plain(keys, x, mono, exclusive, init),
                    mono)
        assert torch.equal(_bits(scan_by_key_apply(keys, x, mono, exclusive,
                                                   init)), _bits(y))
        z = _aligned_like(x).copy_(x)
        assert scan_by_key_apply(keys, z, mono, exclusive, init, out=z) is z
        assert torch.equal(_bits(z), _bits(y))
    before = reduce_by_key_launch.launches
    got = reduce_by_key_apply(keys, x, mono)
    assert reduce_by_key_launch.launches == before + 1
    for k, v, ks in (got, reduce_by_key_apply(keys, x, mono)):
        assert k == m and torch.equal(_bits(v), _bits(totals))
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(ks, tail_keys))
    pm, pv, pk = reduce_by_key_plain(keys, x, mono)
    assert pm == m and all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(got[2], pk))
    _scan_close(got[1], pv, mono)


@pytest.mark.parametrize("nkeys", [1, 2, 7])
@pytest.mark.parametrize("n", BY_KEY_N)
@pytest.mark.parametrize("dt", SCAN_TYPES)
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_by_key_kernels_match_plain(gpu, mono, dt, n, nkeys):
    """The keyed scan in every mode and reduce_by_key, every value type
    and monoid, 1, 2 and 7 key vectors of mixed widths, n around a tile
    and a window: bit for bit today's route (segment flags, segscan,
    compact; the exclusive epilogue), within the scan tolerances of the
    plain versions."""
    n = _by_key_n(n, dt)
    dev = gpu.device
    x = _scan_data(n, dt, n + nkeys).to(dev)
    _check_by_key(_key_vectors(nkeys, n, n, dev), x, mono)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.bfloat16])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_by_key_nan_values_and_keys(gpu, mono, dt):
    """NaN values propagate under MAX and MIN to the end of their run; a
    NaN key is a run of its own and -0.0 equals +0.0 in a key."""
    dev = gpu.device
    n = _by_key_n("window*tile+1", dt) + 5
    x = _scan_data(n, dt, 31).to(dev)
    x[[7, n // 2, n - 1]] = float("nan")
    pos = torch.arange(n, device=dev)
    f = (pos // 40).float()
    f[f == 3] = -0.0                      # runs 3 and 4 (mixed -0.0 and
    f[(f == 4) & (pos % 2 == 0)] = -0.0   # +0.0) are one run
    f[f == 4] = 0.0
    f[[100, 101, n // 2 + 3]] = float("nan")
    keys = (f, _key_vectors(1, n, 32, dev, run=400)[0])
    _check_by_key(keys, x, mono)
    from vexcl_tpu_torch.ops.cuda_by_key import reduce_by_key_apply

    m, v, ks = reduce_by_key_apply(keys, x, mono)
    assert torch.isnan(ks[0]).sum().item() == 3


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 0), (3, 5, 1),
                                     (0, 0, 1)])
@pytest.mark.parametrize("dt", SCAN_TYPES)
def test_by_key_on_unaligned_views(gpu, dt, offsets):
    """x[a:], every key vector [b:] and out[c:] at element offsets, none
    or some 16-byte aligned, over a window and a ragged tail: the kernel
    reads and writes the unaligned ends itself."""
    xo, ko, oo = offsets
    dev = gpu.device
    n = _by_key_n("window*tile+1", dt) + 77
    x = _scan_data(n + xo, dt, 33).to(dev)[xo:]
    keys = tuple(k[ko:] for k in _key_vectors(7, n + ko, 34, dev))
    out = torch.empty(n + oo, dtype=dt, device=dev)[oo:]
    assert all(k.is_contiguous() for k in keys) and x.is_contiguous()
    _check_by_key(keys, x, "add", out_view=out)
    _check_by_key(keys, x, "max")


@pytest.mark.parametrize("case", ["one_run", "all_runs_of_one"])
def test_by_key_at_2_24(gpu, case):
    """A single run of 2^24 elements and 2^24 runs of one, f32."""
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 scan_by_key_apply)

    dev = gpu.device
    n = 1 << 24
    x = _scan_data(n, torch.float32, 35).to(dev)
    k = (torch.zeros(n, dtype=torch.int32, device=dev) if case == "one_run"
         else torch.arange(n, dtype=torch.int32, device=dev))
    _check_by_key((k,), x, "add")
    m, v, (ok,) = reduce_by_key_apply((k,), x, "add")
    if case == "one_run":
        assert m == 1
        _close(v, x.double().sum().reshape(1).float(), 1e-5)
    else:
        assert m == n and torch.equal(v, x) and torch.equal(ok, k)
        assert torch.equal(scan_by_key_apply((k,), x), x)
        assert not scan_by_key_apply((k,), x, exclusive=True).any()


def test_by_key_over_many_calls(gpu):
    """Fifty calls of each entry in a row, each bitwise the first: every
    launch leaves the scratch reset (exclusive scans publish each tile's
    last value in the status words too)."""
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 scan_by_key_apply)

    dev = gpu.device
    n = 3 * _by_key_n("window*tile+1", torch.float32)
    x = _scan_data(n, torch.float32, 36).to(dev)
    keys = _key_vectors(2, n, 37, dev, run=5000)
    s0 = scan_by_key_apply(keys, x, exclusive=True, init=1.0)
    m0, v0, _ = reduce_by_key_apply(keys, x)
    same = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(50):
        same &= torch.equal(scan_by_key_apply(keys, x, exclusive=True,
                                              init=1.0), s0)
        m, v, _ = reduce_by_key_apply(keys, x)
        assert m == m0
        same &= torch.equal(v, v0)
    assert same.item()


def test_by_key_on_two_streams(gpu):
    """Keyed calls enqueued on two streams at once each get their own
    scratch: every result is right."""
    from vexcl_tpu_torch.ops.cuda_by_key import scan_by_key_apply

    dev = gpu.device
    n = 2 * _by_key_n("window*tile+1", torch.float64)
    xs = [_scan_data(n, torch.float64, s).to(dev) for s in (38, 39)]
    keys = _key_vectors(2, n, 40, dev, run=777)
    want = [scan_by_key_apply(keys, x, exclusive=True) for x in xs]
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    res = []
    for _ in range(20):
        for s, x, w in zip((s1, s2), xs, want):
            with torch.cuda.stream(s):
                res.append((w, scan_by_key_apply(keys, x, exclusive=True)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in res)


def test_by_key_scratch_is_bounded(gpu, monkeypatch):
    """More streams than the cache keeps, in turns: the oldest scratch is
    freed, a stream that comes back gets a new one, every result right."""
    from vexcl_tpu_torch.ops import cuda_by_key
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 scan_by_key_apply)

    monkeypatch.setattr(cuda_by_key._scratch, "max_streams", 2)
    dev = gpu.device
    n = (1 << 22) + 9
    x = _scan_data(n, torch.float32, 41).to(dev)
    keys = _key_vectors(1, n, 42, dev, run=300)
    want = (scan_by_key_apply(keys, x), reduce_by_key_apply(keys, x)[1])
    streams = [torch.cuda.Stream() for _ in range(4)]
    torch.cuda.synchronize()
    res = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                res.append((scan_by_key_apply(keys, x),
                            reduce_by_key_apply(keys, x)[1]))
    torch.cuda.synchronize()
    assert len(cuda_by_key._scratch.entries) <= 2
    for a, b in res:
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])


@pytest.mark.parametrize("dt", SCAN_TYPES)
def test_by_key_is_one_kernel_launch(gpu, dt):
    """A keyed call is one kernel on the card, through the API too: no
    flag pass, no fill, no epilogue; reduce_by_key adds only the count's
    copy to the host."""
    dev = gpu.device
    n = 1 << 20
    hx = _scan_data(n, dt, 43)
    x = vex.vector(data=hx.to(dev), context=gpu)
    k = _vec(gpu, (torch.arange(n) // 64).to(torch.int32))
    y = vex.vector(n, dtype=dt, context=gpu)
    calls = {"inclusive": lambda: vex.inclusive_scan_by_key(k, x, y),
             "exclusive_init": lambda: vex.exclusive_scan_by_key(
                 k, x, y, init=1),
             "new_output": lambda: vex.inclusive_scan_by_key(k, x),
             "reduce_by_key": lambda: vex.reduce_by_key(k, x)}
    for name, fn in calls.items():
        fn()                              # the scratch, at first use
        kernels = _kernels_launched(fn)
        if name == "reduce_by_key":       # and the count to the host
            assert ("Memcpy DtoH (Device -> Pinned)", 3) in kernels or (
                "Memcpy DtoH (Device -> Pageable)", 3) in kernels, kernels
            kernels = [kc for kc in kernels if not kc[0].startswith(
                "Memcpy DtoH")]
        assert len(kernels) == 1 and "by_key_kernel" in kernels[0][0], (
            name, kernels)
        assert kernels[0][1] == 3


def test_by_key_rejects_what_it_cannot_take(gpu):
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_apply,
                                                 scan_by_key_apply)

    dev = gpu.device
    k = torch.zeros(10, dtype=torch.int32, device=dev)
    x = torch.ones(10, device=dev)
    with pytest.raises(NotImplementedError):
        scan_by_key_apply((k,), x.half())
    with pytest.raises(NotImplementedError):
        reduce_by_key_apply((k.to(torch.complex128),), x)
    with pytest.raises(NotImplementedError):
        reduce_by_key_apply((k.to(torch.float8_e4m3fn),), x)
    with pytest.raises(ValueError):
        scan_by_key_apply((k,) * 8, x)
    kf = k.float()
    with pytest.raises(ValueError):       # out may not be a key
        scan_by_key_apply((kf,), x, out=kf)
    xb = torch.ones(11, device=dev)
    with pytest.raises(ValueError):       # nor a shifted part of x
        scan_by_key_apply((k,), xb[:10], out=xb[1:])
    # a custom op or key_eq takes today's route, not the kernel
    before = scan_by_key_apply.launches
    xv, kv = _vec(gpu, x), _vec(gpu, k)
    vex.inclusive_scan_by_key(kv, xv, key_eq=lambda a, b: a == b)
    vex.inclusive_scan_by_key(kv, xv, op=lambda a, b: a + b)
    assert scan_by_key_apply.launches == before


def test_scan_family_api_runs_the_kernels(gpu):
    """The standard monoids reach the kernels through every entry point
    (the keyed calls one launch of the keyed kernel each); a custom op
    runs the plain log-depth scan (no scan kernel launch), reduce_by_key
    still compacts with the kernel."""
    from vexcl_tpu_torch.ops.cuda_by_key import (reduce_by_key_launch,
                                                 scan_by_key_apply)
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply
    from vexcl_tpu_torch.ops.cuda_scan import scan_apply, segscan_apply

    n = (1 << 16) + 5
    rng = np.random.default_rng(11)
    hx = rng.random(n).astype(np.float32)
    hk = np.sort(rng.integers(0, n // 30, n)).astype(np.int32)
    x, k = _vec(gpu, hx), _vec(gpu, hk)

    def launches():
        return np.array([scan_apply.launches, segscan_apply.launches,
                         compact_apply.launches, scan_by_key_apply.launches,
                         reduce_by_key_launch.launches])

    for op in (None, torch.add, torch.maximum, torch.minimum):
        for name in ((None,) if op is not None else (None, "max", "min")):
            before = launches()
            vex.inclusive_scan(x, op=op, op_name=name)
            vex.exclusive_scan(x, init=1.0, op=op, op_name=name)
            vex.inclusive_scan_by_key(k, x, op=op, op_name=name)
            vex.exclusive_scan_by_key(k, x, op=op, op_name=name)
            ok, ov, m = vex.reduce_by_key(k, x, op=op, op_name=name)
            assert (launches() - before).tolist() == [2, 0, 0, 2, 1], (
                op, name)
    before = launches()
    custom = lambda a, b: a + b  # noqa: E731
    y = vex.inclusive_scan(x, op=custom)
    ok, ov, m = vex.reduce_by_key(k, x, op=custom)
    assert (launches() - before).tolist() == [0, 0, 1, 0, 0]
    _close(y.storage, torch.cumsum(x.storage.double(), 0), 1e-5)
    heads = np.r_[True, hk[1:] != hk[:-1]]
    sums = np.add.reduceat(hx.astype(np.float64), np.flatnonzero(heads))
    assert m == heads.sum()
    _close(ov.storage, torch.from_numpy(sums), 1e-5)
    # in place through the API: the kernel writes into x
    ref = torch.cumsum(x.storage.double(), 0)
    before = scan_apply.launches
    assert vex.inclusive_scan(x, x) is x
    assert scan_apply.launches == before + 1
    _close(x.storage, ref, 1e-5)


def test_sort_and_reduce_by_key_on_the_card(gpu):
    n = 100003
    rng = np.random.default_rng(12)
    hk = rng.integers(0, 1000, n).astype(np.int32)
    hv = rng.random(n).astype(np.float32)
    k, v = _vec(gpu, hk), _vec(gpu, hv)
    vex.sort_by_key(k, v)
    order = np.argsort(hk, kind="stable")
    assert np.array_equal(k.to_numpy(), hk[order])
    assert np.array_equal(v.to_numpy(), hv[order])
    ok, ov, m = vex.reduce_by_key(k, v)
    uk, first = np.unique(hk[order], return_index=True)
    assert m == len(uk) and np.array_equal(ok.to_numpy(), uk)
    sums = np.add.reduceat(hv[order].astype(np.float64), first)
    _close(ov.storage, torch.from_numpy(sums), 1e-5)
    ku = _vec(gpu, hk.astype(np.uint32))
    vex.sort(ku, descending=True)
    assert np.array_equal(ku.to_numpy(), np.sort(hk)[::-1].astype(np.uint32))


# -- the RNG: the Philox kernel, the fused generators, the known answers --

PHILOX_KATS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
THREEFRY_KATS = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0)),
]


def _words(t):
    return tuple(int(w) & 0xFFFFFFFF for w in t.cpu())


@pytest.mark.parametrize("source", ["iota", "counters"])
@pytest.mark.parametrize("nwords", [1, 2, 4])
def test_philox_bits_kernel_matches_plain(gpu, nwords, source):
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits, philox_bits_plain

    key, start = (0x89ABCDEF, 0x7), (1 << 32) - 1000
    ctr = None
    if source == "counters":
        ctr = torch.from_numpy(np.random.default_rng(13).integers(
            0, 1 << 40, N)).to(gpu.device)
    before = philox_bits.launches
    k = philox_bits(N, nwords, key, counters=ctr, start=start,
                    device=gpu.device)
    p = philox_bits_plain(N, nwords, key, counters=ctr, start=start,
                          device=gpu.device)
    torch.cuda.synchronize()
    assert philox_bits.launches == before + 1
    assert k.shape == (nwords, N) and torch.equal(k, p)


@pytest.mark.parametrize("kat", range(3))
def test_generator_known_answers_on_the_card(gpu, kat):
    """The Philox kernel and the rounds the expression kernel fuses give
    Random123's known answers."""
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits
    from vexcl_tpu_torch.ops.random import generator_rounds

    ctr, key, want = PHILOX_KATS[kat]
    planes = philox_bits(1, 4, key, c123=ctr[1:], counters=torch.tensor(
        [ctr[0]], device=gpu.device))
    assert _words(planes[:, 0]) == want
    got = generator_rounds("philox", torch.tensor(ctr, device=gpu.device)
                           .view(4, 1), torch.tensor(key, device=gpu.device)
                           .view(2, 1))
    assert _words(got[:, 0]) == want
    ctr, key, want = THREEFRY_KATS[kat]
    got = generator_rounds("threefry", torch.tensor(ctr, device=gpu.device)
                           .view(2, 1), torch.tensor(key, device=gpu.device)
                           .view(2, 1))
    assert _words(got[:, 0]) == want


@pytest.mark.parametrize("dt, normal", [
    (torch.float32, False), (torch.float64, False), (torch.bfloat16, False),
    (torch.int32, False), (torch.float32, True), (torch.float64, True),
    (torch.bfloat16, True)], ids=str)
@pytest.mark.parametrize("gen", ["philox", "threefry", "hw"])
def test_generators_kernel_match_plain(gpu, gen, dt, normal):
    """Fused generators against their plain versions: uniforms bitwise,
    normals within a few ulp (libdevice against PyTorch's log/cos)."""
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits
    from vexcl_tpu_torch.ops.random import Random, RandomNormal

    rnd = (RandomNormal if normal else Random)(dt, gen)
    seed = (1 << 31) + 5
    before = philox_bits.launches
    k, p = _both(rnd(vex.element_index(7), seed), N, dt, gpu.device)
    assert philox_bits.launches == before + (gen == "hw")
    ref = rnd.plain(torch.arange(7, 7 + N, device=gpu.device), seed)
    assert torch.equal(p, ref)
    if normal:
        _close(k, p, 4 * RTOL.get(dt, 2e-6) if dt != torch.bfloat16 else 1e-2)
    else:
        assert torch.equal(k, p)
    if gen == "hw":
        x = vex.vector(N, dtype=dt, context=gpu)
        x[:] = (RandomNormal if normal else Random)(dt, "philox")(
            vex.element_index(7), seed)
        assert torch.equal(x.storage, k)


def test_generators_with_vector_seed_and_index(gpu):
    from vexcl_tpu_torch.ops.random import Random

    rng = np.random.default_rng(14)
    idx = _vec(gpu, rng.integers(0, 1 << 40, N))
    seeds = _vec(gpu, rng.integers(-(1 << 62), 1 << 62, N))
    for gen in ("philox", "threefry", "hw"):
        rnd = Random(torch.float64, gen)
        k, p = _both(rnd(idx, 99 if gen == "hw" else seeds), N,
                     torch.float64, gpu.device)
        assert torch.equal(k, p)
    with pytest.raises(ValueError, match="host integer seed"):
        vex.vector(N, context=gpu).assign(Random(torch.float32, "hw")(
            vex.element_index(), seeds))


def test_monte_carlo_models_on_the_card(gpu):
    from vexcl_tpu_torch.models import estimate_pi, gbm_terminal_mean

    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    n = 1 << 18
    assert estimate_pi(n, 5, context=gpu, dtype=torch.float64) == \
        estimate_pi(n, 5, context=cpu, dtype=torch.float64)
    a = gbm_terminal_mean(1 << 14, 8, context=gpu)
    b = gbm_terminal_mean(1 << 14, 8, context=cpu)
    assert abs(a - b) <= 1e-5 * abs(b)


# -- the runtime: user CUDA and Triton kernels, events, enqueue, dlpack --

USER_CUDA = r'''
extern "C" __global__ void triple(const float* x, float* y, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = 3.0f * x[i];
}
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
'''

USER_TRITON = '''import triton
import triton.language as tl


@triton.jit
def axpy(x_ptr, y_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m)
    tl.store(out_ptr + offs, 2.0 * x + tl.load(y_ptr + offs, mask=m), mask=m)
'''


def test_custom_kernel_cuda_and_triton_forms(gpu):
    from vexcl_tpu_torch._build import triton_module

    rng = np.random.default_rng(15)
    x, y = (_vec(gpu, rng.standard_normal(N).astype(np.float32))
            for _ in range(2))
    before = vex.CustomKernel.launches
    t = vex.CustomKernel(USER_CUDA, name="triple")(x)
    a = vex.CustomKernel(USER_CUDA, name="axpy")(x, y)
    b = vex.CustomKernel(triton_module(USER_TRITON).axpy, BLOCK=1024)(x, y)
    c = vex.backend.launch(USER_CUDA, x, name="triple", block=128)
    torch.cuda.synchronize()
    assert vex.CustomKernel.launches == before + 4
    assert t.context is gpu and torch.equal(t.storage, 3 * x.storage)
    assert torch.equal(c.storage, t.storage)
    ref = 2 * x.storage + y.storage
    _close(a.storage, ref, 2e-7)
    _close(b.storage, ref, 2e-7)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        vex.CustomKernel('extern "C" __global__ void bad(float* y) '
                         '{ y[0] = undefined; }')(x)


def test_events_enqueue_and_dlpack_on_the_card(gpu):
    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    a = _vec(gpu, np.arange(N, dtype=np.float32))
    x = vex.vector(N, context=cpu)
    vex.enqueue(gpu)(x)[:] = 2 * a            # x migrates to the card
    ev = vex.enqueue_marker(gpu)
    ev.wait()
    assert ev.complete and x.context is gpu
    assert torch.equal(x.storage, 2 * a.storage)
    vex.enqueue(cpu)(x)[:] = x + 1            # and back to the CPU
    vex.enqueue_barrier(gpu)
    assert x.context is cpu and x.storage.device.type == "cpu"
    assert torch.equal(x.storage, (2 * a.storage + 1).cpu())
    y = vex.interop.from_dlpack(vex.interop.to_dlpack(a))
    assert y.storage.data_ptr() == a.storage.data_ptr()
    assert y.context.device == gpu.device


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


@pytest.fixture(scope="module")
def cpu():
    return vex.Context(vex.Filter.CPU, set_current=False)


def _bits(t):
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()])
    return t


def _bitwise(k, p):
    assert k.dtype == p.dtype and k.shape == p.shape
    assert torch.equal(_bits(k), _bits(p))


def _same(k, p):
    """Equal values, NaN where a NaN is (whatever its bits)."""
    k, p = k.cpu(), p.cpu()
    assert k.dtype == p.dtype and torch.equal(torch.isnan(k), torch.isnan(p))
    fin = ~torch.isnan(p)
    assert torch.equal(k[fin], p[fin])


def _host_data(n, dt, seed):
    rng = np.random.default_rng(seed)
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n)).to(dt)
    return torch.from_numpy(rng.integers(-1000, 1000, n)).to(dt)


def _on_both(gpu, cpu, fn, *arrays):
    """fn(*vectors) on the card and on the CPU from the same host data:
    [card results, CPU results], each the vectors' tensors on the CPU."""
    out = []
    for c in (gpu, cpu):
        vs = [vex.vector(data=a, context=c) for a in arrays]
        fn(*vs)
        torch.cuda.synchronize()
        out.append([v.storage.cpu() for v in vs])
    return out


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


# -- the scatter kernels (ops/cuda_scatter.py, csrc/scatter.cu) --------------
#
# Each form against its plain version on the card (``scatter_plain``):
# stores, integer add, min and max bitwise; float min and max bitwise to
# ``scatter_reduce_`` (NaN and +-0.0 included); float add 1e-5 (f32) and
# 1e-12 (f64) relative to the largest magnitude (atomics sum in no fixed
# order).  Duplicate indices only under add, min and max.

_SCATTER_TYPES = [torch.float32, torch.float64, torch.int32, torch.int64]


def _scatter_data(n, dt, seed, lo=-1000, hi=1000):
    rng = np.random.default_rng(seed)
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n) * 100).to(dt)
    return torch.from_numpy(rng.integers(lo, hi, n)).to(dt)


def _scatter_index(target, n, mode, seed, idt=torch.int32, spill=0):
    """A permutation prefix (unique) for stores, repeated indices else;
    ``spill`` of them out of range or negative."""
    rng = np.random.default_rng(seed)
    if mode == "store":
        h = rng.permutation(target)[:n] if n <= target else \
            rng.permutation(n) % target
        if n > target:
            h = h[:target]
    else:
        h = rng.integers(0, target, n)
    if spill:
        at = rng.choice(len(h), spill, replace=False)
        h[at] = rng.choice([-1, -target, target, target + 7, -target - 3],
                           spill)
        if mode == "store":   # a wrapped negative must not meet its twin
            keep = np.ones(len(h), bool)
            wrapped = np.where(h < 0, h + target, h)
            _, first = np.unique(wrapped, return_index=True)
            keep[:] = False
            keep[first] = True
            h = h[keep]
    return torch.from_numpy(h.astype(np.int64)).to(idt)


def _scatter_check(k, p, mode, dt):
    k, p = k.cpu(), p.cpu()
    if mode == "add" and dt.is_floating_point:
        _close(k, p, 1e-5 if dt == torch.float32 else 1e-12)
    else:
        _bitwise(k, p)


@pytest.mark.parametrize("case", [(1000, 1000), (4096 * 3 + 5, 700),
                                  ((1 << 20) - 1, 1 << 16),
                                  ((1 << 21) + 3, (1 << 21) + 3),
                                  (1 << 20, 1 << 22)])
@pytest.mark.parametrize("mode", ["store", "add", "min", "max"])
@pytest.mark.parametrize("dt", _SCATTER_TYPES)
def test_scatter_ranges_matches_plain(gpu, dt, mode, case):
    """Form A at sizes below and above the route's thresholds, one
    partial range, a ragged last range and tile, n below, at and above
    the target length, i32 and i64 indices with some out of range."""
    from vexcl_tpu_torch.ops.cuda_scatter import scatter_plain, scatter_ranges

    target, n = case
    if mode == "store" and n > target:
        pytest.skip("unique indices: n at most the target")
    for idt, scalar in ((torch.int32, None), (torch.int64, 3)):
        idx = _scatter_index(target, n, mode, 1, idt, spill=17).to(
            gpu.device)
        y = _scatter_data(target, dt, 2).to(gpu.device)
        v = None if scalar is not None else \
            _scatter_data(idx.numel(), dt, 3).to(gpu.device)
        s = None if v is not None else torch.tensor(scalar, dtype=dt)
        k, p = y.clone(), y.clone()
        before = scatter_ranges.launches
        scatter_ranges(k, idx, v, mode, s)
        scatter_plain(p, idx, v, mode, s)
        torch.cuda.synchronize()
        assert scatter_ranges.launches == before + 1
        _scatter_check(k, p, mode, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.int64])
def test_scatter_ranges_pairs_match_mirror(gpu, dt):
    """Form A's scratch on the card against its CPU mirror's: the ranges'
    totals and first pairs and each tile's offsets bit for bit, and each
    (tile, range) run of pairs the same pairs (the kernel places a run's
    pairs in the order of its shared-memory atomics, the mirror in the
    index's); the target bit for bit, for stores."""
    from vexcl_tpu_torch.ops.cuda_scatter import (_ranges_launch, range_plan,
                                                  ranges_mirror)

    target, n = (1 << 21) + 3, (1 << 21) - 11
    idx = _scatter_index(target, n, "store", 4, spill=9)
    y = _scatter_data(target, dt, 5)
    v = _scatter_data(idx.numel(), dt, 6)
    plan = range_plan(target, idx.numel(), y.element_size())
    k = y.to(gpu.device)
    got = _ranges_launch(k, idx.to(gpu.device), v.to(gpu.device), "store",
                         plan=plan, keep=True)
    m = y.clone()
    want = ranges_mirror(m, idx, v, "store", plan=plan)
    torch.cuda.synchronize()
    cnt = int(want["totals"].sum())
    assert torch.equal(got["totals"].cpu().long(), want["totals"])
    assert torch.equal(got["bases"].cpu().long(), want["bases"])
    assert torch.equal(got["counts"].cpu().long().view(plan.tiles,
                                                        plan.ranges).t(),
                       want["offsets"] - want["bases"][:, None])
    run = torch.repeat_interleave(torch.arange(plan.ranges * plan.tiles),
                                  want["counts"].t().reshape(-1))
    gp = got["ppos"][:cnt].cpu().long() & 0xFFFF
    gv = got["pval"][:cnt].cpu()
    go = torch.argsort(run * 65536 + gp)
    wo = torch.argsort(run * 65536 + want["ppos"])
    assert torch.equal(gp[go], want["ppos"][wo])
    _bitwise(gv[go], want["pval"][wo])
    _bitwise(k, m)


@pytest.mark.parametrize("case", [(97, 1 << 16), ((1 << 15) + 1, 1 << 20),
                                  (1 << 16, 1 << 22),
                                  ((1 << 17) + 5, 1 << 21)])
@pytest.mark.parametrize("mode", ["add", "min", "max"])
@pytest.mark.parametrize("dt", _SCATTER_TYPES)
def test_scatter_privatized_matches_plain(gpu, dt, mode, case):
    """Form B: a tiny target, one window and a ragged second, two and
    five windows of f32 (f64's window holds half as many), values and a
    scalar, i32 and i64 indices with some out of range."""
    from vexcl_tpu_torch.ops.cuda_scatter import (scatter_plain,
                                                  scatter_privatized)

    target, n = case
    for idt, scalar in ((torch.int32, None), (torch.int64, -2)):
        idx = _scatter_index(target, n, mode, 7, idt, spill=33).to(
            gpu.device)
        y = _scatter_data(target, dt, 8).to(gpu.device)
        v = None if scalar is not None else \
            _scatter_data(n, dt, 9).to(gpu.device)
        s = None if v is not None else torch.tensor(scalar, dtype=dt)
        k, p = y.clone(), y.clone()
        before = scatter_privatized.launches
        scatter_privatized(k, idx, v, mode, s)
        scatter_plain(p, idx, v, mode, s)
        torch.cuda.synchronize()
        assert scatter_privatized.launches == before + 1
        _scatter_check(k, p, mode, dt)


@pytest.mark.parametrize("form", ["ranges", "privatized"])
@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_scatter_nan_and_signed_zeros(gpu, dt, mode, form):
    """Float min and max bitwise to ``scatter_reduce_`` on the card with
    NaN and +-0.0 in the target and in the values (unique indices: with
    repeated ones the order of +-0.0 is the atomics')."""
    from vexcl_tpu_torch.ops.cuda_scatter import FORMS, scatter_plain

    target = (1 << 20) + 9 if form == "ranges" else (1 << 15) + 9
    rng = np.random.default_rng(11)
    special = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf])
    y = torch.from_numpy(rng.choice(special, target)).to(dt)
    v = torch.from_numpy(rng.choice(special, target)).to(dt)
    idx = torch.from_numpy(rng.permutation(target)).to(torch.int32)
    k, p = (t.to(gpu.device) for t in (y, y))
    FORMS[form](k, idx.to(gpu.device), v.to(gpu.device), mode)
    scatter_plain(p, idx.to(gpu.device), v.to(gpu.device), mode)
    torch.cuda.synchronize()
    _bitwise(k, p)


def test_scatter_on_two_streams(gpu):
    """Both forms enqueued on two streams at once: each result its plain
    version's."""
    from vexcl_tpu_torch.ops.cuda_scatter import (scatter_plain,
                                                  scatter_privatized,
                                                  scatter_ranges)

    dev = gpu.device
    target = 1 << 21
    idx = _scatter_index(target, target, "store", 12).to(dev)
    keys = torch.randint(0, 1 << 16, (1 << 22,), device=dev,
                         dtype=torch.int32)
    vals = _scatter_data(target, torch.float32, 13).to(dev)
    want_s = torch.zeros(target, device=dev)
    scatter_plain(want_s, idx, vals, "store")
    want_h = torch.bincount(keys.long(), minlength=1 << 16).int()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            y = torch.zeros(target, device=dev)
            h = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
            for _ in range(3):
                scatter_ranges(y, idx, vals, "store")
                h.zero_()
                scatter_privatized(h, keys, None, "add",
                                   torch.tensor(1, dtype=torch.int32))
            outs.append((y, h))
    torch.cuda.synchronize()
    for y, h in outs:
        _bitwise(y, want_s)
        assert torch.equal(h, want_h)


def test_scatter_route_launches(gpu, cpu):
    """Through the API: the forms ``route`` picks launch their kernels and
    no ``assign_view_kernel``; the profiler sees only theirs; the other V3
    forms (slices, ``*=``, small scatters) launch the Triton kernel once
    an assignment; an expression index and value take one K1 launch
    first.  Each result equals the CPU's."""
    from vexcl_tpu_torch.expr.triton_emit import assign_multi, assign_to_view
    from vexcl_tpu_torch.ops.cuda_scatter import (route, scatter_privatized,
                                                  scatter_ranges)

    big = 1 << 23
    assert route("store", torch.float32, big, big) == "ranges"
    assert route("add", torch.int32, 1 << 16, 1 << 23) == "privatized"
    assert route("mul", torch.float32, big, big) is None
    assert route("store", torch.float32, 4096, 4096) is None
    hp = _scatter_index(big, big, "store", 14)
    hx = _scatter_data(big, torch.float32, 15)
    hk = torch.from_numpy(np.random.default_rng(16).integers(
        0, 1 << 16, 1 << 23)).to(torch.int32)
    counters = {"ranges": scatter_ranges, "privatized": scatter_privatized,
                "triton": assign_to_view, "k1": assign_multi}
    cases = [
        ("ranges", 0, lambda y, p, x, k, h: vex.permutation(p)(y).assign(x)),
        ("privatized", 0, lambda y, p, x, k, h: vex.eval(vex.atomic_add(
            vex.permutation(k)(h), 1))),
        ("triton", 0, lambda y, p, x, k, h: vex.permutation(p)(y).assign(
            x, "*=")),
        ("triton", 0, lambda y, p, x, k, h: y[3:3003:3].assign(x[0:1000])),
        ("triton", 0, lambda y, p, x, k, h: vex.permutation(p[0:4096])(
            h).assign(k[0:4096])),
        ("ranges", 1, lambda y, p, x, k, h: vex.permutation(p * 1)(y).assign(
            x * 2)),
    ]
    for form, k1, case in cases:
        def run(y, p, x, k, h):
            case(y, p, x, k, h)
        vs = [vex.vector(data=a, context=gpu)
              for a in (hx * 0, hp, hx, hk, torch.zeros(1 << 16,
                                                        dtype=torch.int32))]
        before = {key: c.launches for key, c in counters.items()}
        run(*vs)
        torch.cuda.synchronize()
        got = {key: c.launches - before[key] for key, c in counters.items()}
        want = {key: int(key == form) for key in counters}
        want["k1"] = k1
        assert got == want, (form, got)
        cv = [vex.vector(data=a, context=cpu)
              for a in (hx * 0, hp, hx, hk, torch.zeros(1 << 16,
                                                        dtype=torch.int32))]
        run(*cv)
        for a, b in zip(vs, cv):
            _bitwise(a.storage, b.storage)
        if form != "triton" and not k1:
            names = [name for name, _ in _kernels_launched(
                lambda: run(*vs), reps=2)]
            assert not any("assign_view_kernel" in name for name in names)
            assert any(("build_kernel" if form == "ranges"
                        else "privatized_kernel") in name for name in names), \
                names


def test_scatter_truncates_i64_indices(gpu):
    """i64 indices above 2^31 are truncated to i32 first (then wrapped
    and dropped), as the reference does."""
    from vexcl_tpu_torch.ops.cuda_scatter import (scatter_plain,
                                                  scatter_privatized,
                                                  scatter_ranges)

    target = 1 << 20
    base = _scatter_index(target, target, "store", 17, torch.int64)
    shift = torch.from_numpy(np.random.default_rng(18).integers(
        -3, 4, target)) << 32
    idx = (base + shift).to(gpu.device)
    assert idx.abs().max().item() > 1 << 31
    v = _scatter_data(target, torch.float32, 19).to(gpu.device)
    for fn, mode in ((scatter_ranges, "store"), (scatter_ranges, "max"),
                     (scatter_privatized, "add")):
        k = torch.zeros(target, device=gpu.device)
        p = torch.zeros_like(k)
        fn(k, idx, v, mode)
        scatter_plain(p, idx, v, mode)
        torch.cuda.synchronize()
        _scatter_check(k, p, mode, torch.float32)


# -- the gather through a permutation (ops/cuda_gather.py, csrc/gather.cu) ---
#
# The form against its plain version (``gather_plain``) and
# ``index_select`` on the card, bitwise (a gather moves bits; the fill of
# an index out of range is the plain version's NaN or least integer).

_GATHER_TYPES = [torch.float32, torch.float64, torch.int32, torch.int64]


def _gather_index(src_len, n, seed, idt=torch.int32, spill=0):
    """A permutation's prefix where n is at most the source, uniform
    indices otherwise; ``spill`` of them negative (wrapping) or out of
    range."""
    rng = np.random.default_rng(seed)
    h = rng.permutation(src_len)[:n] if n <= src_len else \
        rng.integers(0, src_len, n)
    if spill:
        at = rng.choice(n, spill, replace=False)
        h[at] = rng.choice([-1, -src_len, src_len, src_len + 7,
                            -src_len - 3, 1 << 30], spill)
    return torch.from_numpy(h.astype(np.int64)).to(idt)


def _gather_valid(idx, src_len):
    j = idx.long().cpu()
    j = torch.where(j < 0, j + src_len, j)
    return (j >= 0) & (j < src_len), j


@pytest.mark.parametrize("case", [(1000, 1000), (4096 * 3 + 5, 700),
                                  ((1 << 16) - 1, (1 << 16) + 8),
                                  ((1 << 16) + 1, (1 << 14) * 3 + 1),
                                  ((1 << 20) + 3, 1 << 20),
                                  (1 << 18, (1 << 22) + 5)])
@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("dt", _GATHER_TYPES)
def test_gather_ranges_matches_plain(gpu, dt, idt, case, monkeypatch):
    """The form at sources of one and many ranges (ranges of 2^10
    elements here: up to 1025 of them), ragged last ranges and tiles, n
    below, at and above the source length, some indices negative or out
    of range: bitwise its plain version, and ``index_select`` at the
    valid indices; one launch."""
    from vexcl_tpu_torch.ops import cuda_gather as cg

    monkeypatch.setattr(cg, "RANGE_ELEMENTS", 1 << 10)
    src_len, n = case
    idx = _gather_index(src_len, n, 21, idt, spill=min(n // 4, 97))
    src = _scatter_data(src_len, dt, 22).to(gpu.device)
    idx_d = idx.to(gpu.device)
    k = torch.empty(n, dtype=dt, device=gpu.device)
    p = torch.empty_like(k)
    before = cg.gather_ranges.launches
    cg.gather_ranges(k, idx_d, src)
    cg.gather_plain(p, idx_d, src)
    torch.cuda.synchronize()
    assert cg.gather_ranges.launches == before + 1
    _bitwise(k, p)
    valid, j = _gather_valid(idx, src_len)
    _bitwise(k.cpu()[valid], torch.index_select(src.cpu(), 0, j[valid]))


@pytest.mark.parametrize("cut", [(1 << 12, 8), (1 << 14, 40),
                                 (1 << 17, 1 << 14), (1 << 16, 24576)])
@pytest.mark.parametrize("dt", [torch.float32, torch.int64])
def test_gather_plan_matches_mirror(gpu, dt, cut):
    """The form's scratch against its CPU mirror's at four cuts (range
    bytes, tile): the tiles' bucket starts bit for bit, each (tile, bucket)
    run the same (index within the range, offset, value) entries (the
    kernel orders a run by its atomics), every offset of a tile once (the
    restore inverts the partition); the output bit for bit."""
    from vexcl_tpu_torch.ops import cuda_gather as cg

    src_len, n = (1 << 20) + 3, (1 << 20) - 11
    idx = _gather_index(src_len, n, 23, spill=50)
    src = _scatter_data(src_len, dt, 24)
    plan = cg.gather_plan(src_len, n, src.element_size(), *cut)
    k = torch.empty(n, dtype=dt, device=gpu.device)
    got = cg._launch(k, idx.to(gpu.device), src.to(gpu.device), plan,
                     keep=True)
    m = torch.empty(n, dtype=dt)
    want = cg.ranges_mirror(m, idx, src, plan)
    torch.cuda.synchronize()
    assert torch.equal(got["starts"].cpu().long(), want["starts"])
    run = torch.repeat_interleave(
        torch.arange(plan.tiles * (plan.ranges + 1)),
        torch.diff(want["starts"], dim=0).t().reshape(-1))
    gs = got["sidx"][:n].cpu().long() & 0xFFFF
    go_ = got["soff"].cpu().long() & 0xFFFF
    gv = got["sval"].cpu()
    go = torch.argsort(run * 65536 + go_)
    wo = torch.argsort(run * 65536 + want["soff"])
    assert torch.equal(go_[go], want["soff"][wo])
    assert torch.equal(gs[go], want["sidx"][wo])
    _bitwise(gv[go], want["sval"][wo])
    tile_of = torch.arange(n) // plan.tile
    assert torch.equal(torch.sort(tile_of * plan.tile + go_).values,
                       torch.arange(n))
    _bitwise(k, m)


@pytest.mark.parametrize("order", ["sorted", "one_range", "one_index",
                                   "reversed"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_gather_clustered_indices(gpu, dt, order):
    """Indices that crowd few ranges: sorted (each tile's entries in one
    or two ranges), all in one range, one index repeated, reversed; each
    warp's entries in one range take one atomic, and one long run is
    shared by the gather block's warps: bitwise ``index_select``."""
    from vexcl_tpu_torch.ops import cuda_gather as cg

    src_len = (1 << 22) + 5
    rng = np.random.default_rng(33)
    h = {"sorted": np.sort(rng.integers(0, src_len, src_len)),
         "one_range": rng.integers(5000, 5000 + 3000, src_len),
         "one_index": np.full(src_len, 77),
         "reversed": np.arange(src_len)[::-1].copy()}[order]
    idx = torch.from_numpy(h).to(torch.int32).to(gpu.device)
    src = _scatter_data(src_len, dt, 34).to(gpu.device)
    k = torch.empty(src_len, dtype=dt, device=gpu.device)
    cg.gather_ranges(k, idx, src)
    torch.cuda.synchronize()
    _bitwise(k, torch.index_select(src, 0, idx))


def test_gather_truncates_i64_indices(gpu):
    """i64 indices above 2^31 are truncated to i32 first (then wrapped or
    read as the fill), as ``astype(int32)``."""
    from vexcl_tpu_torch.ops import cuda_gather as cg

    src_len = 1 << 20
    base = _gather_index(src_len, src_len, 25, torch.int64)
    shift = torch.from_numpy(np.random.default_rng(26).integers(
        -3, 4, src_len)) << 32
    idx = (base + shift).to(gpu.device)
    assert idx.abs().max().item() > 1 << 31
    src = _scatter_data(src_len, torch.float32, 27).to(gpu.device)
    k, p = (torch.empty(src_len, device=gpu.device) for _ in range(2))
    cg.gather_ranges(k, idx, src)
    cg.gather_plain(p, idx, src)
    torch.cuda.synchronize()
    _bitwise(k, p)


def test_gather_on_two_streams(gpu):
    """The form enqueued on two streams at once, three calls each: each
    result ``index_select``'s."""
    from vexcl_tpu_torch.ops import cuda_gather as cg

    dev = gpu.device
    src_len = (1 << 22) + 1
    idx = _gather_index(src_len, src_len, 28).to(dev)
    src = _scatter_data(src_len, torch.float32, 29).to(dev)
    want = torch.index_select(src, 0, idx)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            y = torch.zeros(src_len, device=dev)
            for _ in range(3):
                cg.gather_ranges(y, idx, src)
            outs.append(y)
    torch.cuda.synchronize()
    for y in outs:
        _bitwise(y, want)


def test_gather_route_launches(gpu, cpu):
    """Through the API: a gather the route takes (2^24 f32 and f64
    sources, i32 and i64 indices, ``vex.gather``, an index or a source
    that shares the output's memory) is one call of the form, no V1
    launch, and the profiler sees its three kernels and no
    ``assign_kernel``; what the route leaves (a small source, an
    expression index, a tree around the view) is one V1 launch.
    Each result equals the CPU's."""
    from vexcl_tpu_torch.expr.triton_emit import assign, assign_indexed
    from vexcl_tpu_torch.ops import cuda_gather as cg

    big = 1 << 24
    assert cg.route(torch.float32, big, big, torch.int32)
    assert not cg.route(torch.float32, 4096, 4096, torch.int32)
    assert not cg.route(torch.bfloat16, big, big, torch.int32)
    hp = _gather_index(big, big, 30, spill=1000)
    hx = _scatter_data(big, torch.float32, 31)
    small = torch.from_numpy(np.random.default_rng(32).integers(
        -5, 4101, big)).to(torch.int32)
    hs = hx[:4096].clone()
    counters = {"form": cg.gather_ranges, "v1": assign_indexed,
                "expr": assign}
    cases = [
        ("form", lambda y, p, x, s, xs: y.assign(vex.permutation(p)(x))),
        ("form", lambda y, p, x, s, xs: p.assign(vex.permutation(p)(s))),
        ("form", lambda y, p, x, s, xs: x.assign(vex.permutation(p)(x))),
        ("v1", lambda y, p, x, s, xs: y.assign(vex.permutation(s)(xs))),
        ("v1", lambda y, p, x, s, xs: y.assign(vex.permutation(p * 1)(x))),
        ("v1", lambda y, p, x, s, xs: y.assign(vex.permutation(p)(x) + 1)),
    ]
    for i, (form, case) in enumerate(cases):
        def make(ctx):
            return [vex.vector(data=a, context=ctx)
                    for a in (hx * 0, hp, hx, small, hs)]
        vs = make(gpu)
        before = {key: c.launches for key, c in counters.items()}
        case(*vs)
        torch.cuda.synchronize()
        got = {key: c.launches - before[key] for key, c in counters.items()}
        cv = make(cpu)
        case(*cv)
        for a, b in zip(vs, cv):
            # V1's NaN + 1 keeps another payload than the CPU's
            (_bitwise if form == "form" else _same)(a.storage, b.storage)
        if form == "v1":
            assert got["form"] == 0 and got["v1"] == 1, (i, got)
            continue
        assert got["form"] >= 1 and got["v1"] == 0, (i, got)
        if i == 0:
            assert got == {"form": 1, "v1": 0, "expr": 0}, got
            names = [name for name, _ in _kernels_launched(
                lambda: case(*vs), reps=2)]
            assert not any("assign_kernel" in name for name in names), names
            for kern in ("partition_kernel", "gather_kernel",
                         "restore_kernel"):
                assert any(kern in name for name in names), names
    # f64 and an i64 index, and vex.gather (i64 indices of the host)
    x64 = vex.vector(data=hx.double(), context=gpu)
    p64 = vex.vector(data=hp.long(), context=gpu)
    y64 = vex.vector(big, dtype=torch.float64, context=gpu)
    before = cg.gather_ranges.launches, assign_indexed.launches
    y64.assign(vex.permutation(p64)(x64))
    got = vex.gather(x64, hp.numpy())
    torch.cuda.synchronize()
    assert (cg.gather_ranges.launches - before[0],
            assign_indexed.launches - before[1]) == (2, 0)
    want = torch.empty(big, dtype=torch.float64)
    cg.gather_plain(want, hp, hx.double())
    _bitwise(y64.storage, want)
    _bitwise(torch.from_numpy(got), want)


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


# -- the builtins' kernel forms on integer types, integer pow, boolean
# arithmetic, advanced slicer keys and image samples --------------------

_INT_TYPES = [torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.uint16, torch.uint32, torch.uint64]
_NP_INT = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
           torch.int64: np.int64, torch.uint8: np.uint8,
           torch.uint16: np.uint16, torch.uint32: np.uint32,
           torch.uint64: np.uint64}


def _int_data(n, dt, seed):
    """Random values over all of dt, after its least and largest values,
    0, 1 and (signed) -1."""
    npdt = _NP_INT[dt]
    info = np.iinfo(npdt)
    rng = np.random.default_rng(seed)
    h = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    special = [info.min, info.max, 0, 1] + ([-1] if info.min < 0 else [])
    h[:len(special)] = np.array(special, dtype=object).astype(npdt)
    return h


#: the integer helpers and builtins that keep an integer type: arity
_INT_BUILTINS = {"popcount": 1, "clz": 1, "__popc": 1, "__popcll": 1,
                 "rotate": 2, "add_sat": 2, "sub_sat": 2, "mul_hi": 2,
                 "mad_hi": 3, "mad_sat": 3, "upsample": 2, "maxmag": 2,
                 "minmag": 2, "step": 2, "any": 1, "all": 1, "select": 3,
                 "hadd": 2, "bitselect": 3, "signbit": 1, "isnormal": 1,
                 "min": 2, "max": 2, "clamp": 3, "sign": 1, "abs": 1}


@pytest.mark.parametrize("name,dt", [
    (name, dt) for name in sorted(_INT_BUILTINS) for dt in _INT_TYPES
    if not (name == "upsample" and dt.itemsize == 8)])
def test_integer_builtin_kernel_bitwise(gpu, name, dt):
    """Each builtin over random bits of every integer type (the type's
    extremes, 0, 1 and -1 first), bitwise against its plain form."""
    n = 20000
    args = [vex.vector(data=_int_data(n, dt, 50 + i), context=gpu)
            for i in range(_INT_BUILTINS[name])]
    expr = vex.as_expr(vex.BUILTINS[name](*args))
    k, p = _both(expr, n, vex.eval(expr).dtype, gpu.device)
    assert torch.equal(k, p), name


@pytest.mark.parametrize("dt", _INT_TYPES)
def test_integer_pow_kernel_bitwise(gpu, dt):
    """Integer ** (square and multiply over the exponent's bits) at
    exponents -3..40 (0..40 unsigned), wrapping, bitwise against PyTorch's
    integer pow; also by a scalar exponent and of a scalar base."""
    n = 20000
    npdt = _NP_INT[dt]
    info = np.iinfo(npdt)
    rng = np.random.default_rng(41)
    lo = -3 if info.min < 0 else 0
    base = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                        n).astype(npdt)
    base[:6] = np.array([0, 1, 2, 3, 1, 0]).astype(npdt)
    if info.min < 0:
        base[6:9] = np.array([-1, -2, -3]).astype(npdt)
    exps = rng.integers(lo, 41, n).astype(npdt)
    a = vex.vector(data=base, context=gpu)
    b = vex.vector(data=exps, context=gpu)
    for expr in (a ** b, a ** 3, a ** 40, 2 ** b, a ** b + 1):
        k, p = _both(expr, n, dt, gpu.device)
        assert torch.equal(k, p)


def test_boolean_arithmetic_kernel_bitwise(gpu):
    """Operators and builtins on booleans give what their plain forms give
    (+ is or, * is and; //, %, ** in i32; orders on 0 and 1); - and
    unary - raise TypeError, as PyTorch refuses them."""
    n = 5000
    rng = np.random.default_rng(42)
    b, c, d = (vex.vector(data=rng.random(n) < 0.5, context=gpu)
               for _ in range(3))
    exprs = [b + c, b * c, b * c + d, vex.mad(b, c, d), vex.fma(b, c, d),
             vex.mul24(b, c), vex.mad24(b, c, d), vex.hadd(b, c),
             vex.min(b, c), vex.max(b, c), vex.clamp(b, c, d),
             vex.maxmag(b, c), vex.minmag(b, c), vex.step(b, c), b ** c,
             b // c, b % c, vex.select(b, c, d), b & c, b | c, b ^ c, ~b,
             b == c, b < c, b >= c, vex.isless(b, c), b + 1, b * 2.5,
             vex.rotate(b, c)]
    for e in exprs:
        e = vex.as_expr(e)
        k, p = _both(e, n, vex.eval(e).dtype, gpu.device)
        assert torch.equal(k, p)
    y = vex.vector(n, dtype=torch.bool, context=gpu)
    for e in (lambda: b - c, lambda: -b):
        with pytest.raises(TypeError):
            y[:] = e()


def test_advanced_slicer_keys_kernel_matches_plain(gpu, cpu):
    """Index arrays beside integers, two arrays adjacent and separated by
    a slice (their axis first), an array of one element broadcast, with
    out-of-range indices (wrapped, then clamped): V1's indexed loads, one
    launch each, bitwise against the plain version."""
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed

    dims = (37, 41, 29)
    hx = torch.from_numpy(np.random.default_rng(43).standard_normal(
        int(np.prod(dims))).astype(np.float32))
    hi = np.array([0, 36, -1, 40, -40, 5, 17, 3, 8, 2, 1])
    hj = np.array([28, 0, 13, -3, 41, 7, 6, 5, 4, 3, 2])
    cases = [lambda i, j, o: (i, 5), lambda i, j, o: (3, i),
             lambda i, j, o: (i, j), lambda i, j, o: (i, vex._, j),
             lambda i, j, o: (vex._, i, j), lambda i, j, o: (i, vex._, o),
             lambda i, j, o: (2, vex._, i), lambda i, j, o: (i, 1, j),
             lambda i, j, o: (o, i), lambda i, j, o: (vex.r(1, 30), i, 4)]
    for key in cases:
        res = []
        for c in (gpu, cpu):
            x = vex.vector(data=hx, context=c)
            i, j, o = (vex.vector(data=a, context=c)
                       for a in (hi, hj, np.array([4])))
            view = vex.slicer(dims)[key(i, j, o)](x)
            out = vex.vector(view.size_hint(), dtype=torch.float32,
                             context=c)
            before = assign_indexed.launches
            out[:] = view * 2 + 1
            if c is gpu:
                torch.cuda.synchronize()
                assert assign_indexed.launches == before + 1
            res.append(out.storage.cpu())
        _bitwise(res[0], res[1])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_image_sampling_kernel_matches_plain(gpu, dt):
    """image1d and image2d, nearest (bitwise) and linear (4 RTOL: the
    kernel contracts products into FMAs), at the edges, at halves and
    outside the image; one V1 launch a sample."""
    from vexcl_tpu_torch.expr.triton_emit import assign_indexed

    rng = np.random.default_rng(44)
    h, w, n = 61, 47, 30000
    img = rng.standard_normal((h, w))
    xs = rng.uniform(-3, w + 3, n)
    ys = rng.uniform(-3, h + 3, n)
    edge = [0.0, w - 1.0, -0.5, w - 0.5, 2.5, 3.5, -3.0, w + 2.0]
    xs[:len(edge)], ys[:len(edge)] = edge, edge[::-1]
    npdt = np.float32 if dt == torch.float32 else np.float64
    X = vex.vector(data=xs.astype(npdt), context=gpu)
    Y = vex.vector(data=ys.astype(npdt), context=gpu)
    for f in ("nearest", "linear"):
        im2 = vex.image2d(img.astype(npdt), filter=f, context=gpu)
        im1 = vex.image1d(img[3].astype(npdt), filter=f, context=gpu)
        for expr in (im2(X, Y), im1(X), 2 * im2(X, Y) + im1(Y)):
            before = assign_indexed.launches
            k, p = _both(expr, n, dt, gpu.device)
            assert assign_indexed.launches == before + 1
            if f == "nearest":
                _bitwise(k, p)
            else:
                _close(k, p, 4 * RTOL[dt])


@pytest.mark.parametrize("table", ["i32", "b1", "u16", "c64", "f16_coords",
                                   "i32_coords"])
def test_image_sample_types_kernel_matches_plain(gpu, table):
    """Integer, boolean, unsigned and complex tables with f32
    coordinates, and an f32 table at f16 and i32 coordinates: nearest and
    linear samples inside and outside the image, bitwise (integers and
    nearest samples) or within 4 RTOL (f32 and c64 lerps); one V1 launch
    a sample (counted on ``assign_complex`` for the complex table)."""
    from vexcl_tpu_torch.expr.triton_emit import (assign_complex,
                                                  assign_indexed)

    def launches():
        return assign_indexed.launches + assign_complex.launches

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
    for f in ("nearest", "linear"):
        im2 = vex.image2d(img.astype(npdt), filter=f, context=gpu)
        im1 = vex.image1d(img[2].astype(npdt), filter=f, context=gpu)
        for expr in (im2(X, Y), im1(X)):
            res = vex.eval(expr).dtype
            before = launches()
            k, p = _both(expr, n, res, gpu.device)
            assert launches() == before + 1
            if f == "nearest" or not (res.is_floating_point
                                      or res.is_complex):
                _bitwise(k, p)
            elif res.is_complex:
                _close(torch.view_as_real(k).reshape(-1),
                       torch.view_as_real(p).reshape(-1), 4 * RTOL[
                           torch.float32])
            else:
                _close(k, p, 4 * RTOL[torch.float32])


# -- saturating float-to-integer casts, and the generator's backward kernel

_CAST_SOURCES = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
                 torch.complex64, torch.complex128]
_CAST_TARGETS = [torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8, torch.uint16, torch.uint32, torch.uint64]


def _cast_values(src, n=(1 << 14) + 77):
    """Values of type src: NaN, the infinities, -0.5, +-3.7, every integer
    type's limits with their neighbours in the source type, and random
    values spread over +-2^70 (each sign, every scale)."""
    real = src.to_real() if src.is_complex else src
    rng = np.random.default_rng(40)
    lims = []
    for t in _CAST_TARGETS:
        info = torch.iinfo(t)
        lims += [float(info.min), float(info.max)]
    lims = torch.tensor(lims, dtype=torch.float64).to(real)
    inf = torch.full_like(lims, float("inf"))
    special = torch.cat([torch.tensor([float("nan"), float("inf"),
                                       -float("inf"), -0.5, 3.7, -3.7, 0.0,
                                       -0.0], dtype=real), lims,
                         torch.nextafter(lims, inf),
                         torch.nextafter(lims, -inf)])
    wide = torch.from_numpy(rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(
        -2, 70, n)).to(real)
    x = torch.cat([special, wide])
    if src.is_complex:
        x = torch.complex(x, x.flip(0))
    return x


@pytest.mark.parametrize("src", _CAST_SOURCES)
def test_saturating_casts_kernel_bitwise(gpu, src):
    """Every float (and complex) type into every integer type, through
    ``cast`` and through the store of an assignment, in one k-output
    kernel: the kernel's clamps equal the plain form's bit for bit."""
    x = _vec(gpu, _cast_values(src).to(gpu.device))
    n = x.size
    for make in (lambda t: vex.cast(t, x), lambda t: vex.as_expr(x)):
        exprs = [make(t) for t in _CAST_TARGETS]
        e, an, ty, lv = prepare_multi(exprs, n, gpu.device)
        k = [torch.empty(n, dtype=t, device=gpu.device)
             for t in _CAST_TARGETS]
        p = [torch.empty_like(o) for o in k]
        assign_multi(e, an, ty, lv, k)
        assign_multi_plain(e, an, ty, lv, p)
        torch.cuda.synchronize()
        for t, a, b in zip(_CAST_TARGETS, k, p):
            assert torch.equal(a.cpu(), b.cpu()), (src, t)


def _grad_kernel(name, nargs):
    """The kernel ``y = name(p0, ..)`` of the generator and its params."""
    from vexcl_tpu_torch import generator as tgen

    params = [tgen.symbolic() for _ in range(nargs)]
    y = tgen.symbolic()
    y[:] = vex.BUILTINS[name](*params)
    return tgen.build_kernel(name, [y], params)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(set(vex.BUILTINS)
                                        - NOT_DIFFERENTIABLE))
def test_backward_kernel_matches_plain(gpu, name, dt):
    """Each differentiable builtin's backward kernel (the adjoint tree in
    one K1 launch) against its plain version, element by element, and
    the gradients through autograd equal to the kernel's."""
    rng = np.random.default_rng(41)
    kernel = _grad_kernel(name, vex.BUILTINS[name].nargs)
    lo, hi = GRAD_DOMAIN.get(name, (-3.0, 3.0))
    args = [torch.from_numpy(rng.uniform(lo, hi, N)).to(gpu.device, dt)
            for _ in range(vex.BUILTINS[name].nargs)]
    if name == "ldexp":
        args[1] = torch.from_numpy(rng.integers(-20, 20, N)).to(
            gpu.device, torch.int32)
    cot = torch.from_numpy(rng.uniform(0.5, 1.5, N)).to(gpu.device, dt)
    needs = [a.dtype.is_floating_point for a in args]
    bk = kernel.backward_kernel(args, [cot], needs)
    got = bk.as_function()(*args, cot)
    want = bk.plain(*args, cot)
    for g, w in zip(got, want):
        _close_each(g, w, 4 * RTOL[dt])
    ts = [a.clone().requires_grad_(need) for a, need in zip(args, needs)]
    (out,) = kernel.as_function()(*ts)
    auto = torch.autograd.grad(out, [t for t in ts if t.requires_grad], cot)
    for g, a in zip(got, auto):
        assert torch.equal(g, a)


def test_backward_is_one_launch_a_call(gpu):
    """A backward call of the Lorenz step is one launch of the backward
    kernel (the counter and the profiler); with a 0-d parameter, two: K1
    for the vectors' gradients, K2 for the 0-d one's."""
    from vexcl_tpu_torch import generator as tgen
    from vexcl_tpu_torch.models import LorenzEnsemble
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce_multi

    ens = LorenzEnsemble(1 << 16, context=gpu)
    fn = ens._step.as_function()
    xs = [v.storage.clone().requires_grad_() for v in (ens.x, ens.y, ens.z,
                                                       ens.R)]
    w = torch.rand(1 << 16, device=gpu.device)

    def grads():
        x, y, z, R = xs
        for _ in range(3):
            x, y, z = fn(x, y, z, R)
        return torch.autograd.grad((w * (x + y + z)).sum(), xs)

    grads()
    tgen.backward.launches = assign_multi.launches = 0
    grads()
    torch.cuda.synchronize()
    assert tgen.backward.launches == 3 and assign_multi.launches == 6
    # the backward kernel alone: one kernel a call
    out = fn(*xs)
    launched = _kernels_launched(lambda: torch.autograd.grad(
        out, xs, [w, w, w], retain_graph=True), reps=2)
    assert [c for k, c in launched if "assign_kernel" in k] == [2], launched
    # a 0-d parameter: K1 and K2
    x = torch.rand(1 << 16, device=gpu.device, requires_grad=True)
    a = torch.tensor(1.5, device=gpu.device, requires_grad=True)
    kernel = _grad_kernel("mad", 3)
    (y,) = kernel.as_function()(x, a, x)
    tgen.backward.launches = map_reduce_multi.launches = 0
    assign_multi.launches = 0
    gx, ga = torch.autograd.grad(y, (x, a), w)
    torch.cuda.synchronize()
    assert tgen.backward.launches == 2 and map_reduce_multi.launches == 1
    assert assign_multi.launches == 1
    assert torch.equal(gx, w * a.detach() + w)
    _close(ga.reshape(1), (w * x.detach()).sum().reshape(1), 1e-5)


def test_vmap_kernel_matches_unbatched_calls(gpu):
    """torch.func.vmap over a (4, n) batch is one launch and equals four
    unbatched calls bit for bit."""
    from vexcl_tpu_torch.models import LorenzEnsemble

    ens = LorenzEnsemble(1 << 16, context=gpu)
    fn = ens._step.as_function()
    y, z, R = (v.storage for v in (ens.y, ens.z, ens.R))
    xb = torch.rand(4, 1 << 16, device=gpu.device)
    assign_multi.launches = 0
    got = torch.func.vmap(lambda u: fn(u, y, z, R))(xb)
    assert assign_multi.launches == 1
    for i in range(4):
        one = fn(xb[i], y, z, R)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_digamma_kernel_matches_plain(gpu, dt):
    """lgamma's derivative (``builtins.DIGAMMA``): the kernel form against
    torch.digamma, at the poles and zeros too."""
    from vexcl_tpu_torch.expr.builtins import DIGAMMA

    rng = np.random.default_rng(42)
    x = np.concatenate([[0.0, -0.0, -1.0, -2.0, 10.0, float("inf"),
                         -float("inf"), float("nan"), 1e18, 1e-30],
                        rng.uniform(-6.0, 12.0, N)])
    v = _vec(gpu, torch.from_numpy(x).to(dt))
    k, p = _both(vex.as_expr(DIGAMMA(v)), v.size, dt, gpu.device)
    _close_each(k, p, 4 * RTOL[dt])
