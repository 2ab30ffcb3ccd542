"""The port's three kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports neither jax nor vexcl_tpu, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 results may differ from the plain version by a few ulp
(FMA contraction, libdevice against PyTorch's own math, another summation
order): 2e-6 relative to the largest magnitude, 1e-5 for sums.  f64: 1e-12
and 1e-10 for sums.  MIN, MAX, integer results and the DIA kernel on
integer-valued data are exact.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.triton_emit import assign, assign_plain
from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_plain
from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec, dia_matvec_plain

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


_DOMAIN = {"acosh": (1.0, 3.0), "asin": (-1, 1), "acos": (-1, 1),
           "atanh": (-0.99, 0.99), "log": (0.01, 3), "log2": (0.01, 3),
           "log10": (0.01, 3), "log1p": (0, 3), "sqrt": (0, 4),
           "rsqrt": (0.01, 4), "lgamma": (0.1, 5), "pow": (0.1, 2),
           "powr": (0.1, 2), "pown": (0.1, 2)}


_NARGS = {"atan2": 2, "pow": 2, "powr": 2, "pown": 2, "hypot": 2,
          "fmod": 2, "copysign": 2, "fdim": 2, "abs_diff": 2, "fmin": 2,
          "fmax": 2, "min": 2, "max": 2, "mul24": 2, "isequal": 2,
          "isnotequal": 2, "isgreater": 2, "isgreaterequal": 2, "isless": 2,
          "islessequal": 2, "islessgreater": 2, "isordered": 2,
          "isunordered": 2, "hadd": 2, "rhadd": 2, "clamp": 3, "mix": 3,
          "mad": 3, "fma": 3, "mad24": 3, "bitselect": 3}
_INTEGER_ONLY = ("hadd", "rhadd", "bitselect")


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", KERNEL_BUILTINS)
def test_builtin_kernel_matches_plain(gpu, name, dt):
    fn = vex.BUILTINS[name]
    lo, hi = _DOMAIN.get(name, (-3, 3))
    rng = np.random.default_rng(1)
    if name in _INTEGER_ONLY:
        npdt = np.int32 if dt == torch.float32 else np.int64
        args = [_vec(gpu, rng.integers(-1000, 1000, N).astype(npdt))
                for _ in range(_NARGS[name])]
    else:
        npdt = np.float64 if dt == torch.float64 else np.float32
        args = [_vec(gpu, (lo + (hi - lo) * rng.random(N)).astype(npdt))
                for _ in range(_NARGS.get(name, 1))]
    expr = vex.as_expr(fn(*args))
    res_dt = vex.eval(expr).dtype
    k, p = _both(expr, N, res_dt, gpu.device)
    if not res_dt.is_floating_point:
        assert torch.equal(k, p)
    else:
        _close(k, p, 4 * RTOL[dt])


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
@pytest.mark.parametrize("n", [1000, N, (1 << 20) + 12345])
def test_map_reduce_kernel_matches_plain(gpu, kind, dt, n):
    rng = np.random.default_rng(4)
    npdt = np.float64 if dt == torch.float64 else np.float32
    x = _vec(gpu, rng.random(n).astype(npdt))
    y = _vec(gpu, rng.random(n).astype(npdt) - 0.5)
    for expr in (x * y, vex.exp(x)):
        e, analysis, types, leaves = prepare(expr, n, gpu.device)
        k = map_reduce(e, analysis, types, leaves, n, kind, gpu.device).item()
        p = map_reduce_plain(e, analysis, types, leaves, n, kind,
                             gpu.device).item()
        tol = {torch.float32: 1e-5, torch.float64: 1e-10}[dt]
        if kind == "SUM":
            assert abs(k - p) <= tol * max(1.0, abs(p)), (k, p)
        else:
            assert k == p


def test_reductor_raises_on_uncovered_kinds(gpu):
    x = _vec(gpu, np.ones(100, np.float32))
    with pytest.raises(NotImplementedError):
        vex.Reductor(vex.MIN_MAX)(x)
    with pytest.raises(NotImplementedError):
        vex.Reductor(vex.SUM_Kahan)(x)
    with pytest.raises(NotImplementedError, match="sinpi"):
        y = vex.vector(100, context=gpu)
        y[:] = vex.sinpi(x)


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
    assert A.device.format == "sellr"
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
