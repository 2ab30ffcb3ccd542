"""The DIA SpMV, the stencil, the CSR row-block and SELL kernels (ELL,
hybrid, SELL-R), the CCSR path and the SpMV inside expressions against
their plain versions on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sparse.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec, dia_matvec_plain
from _cuda_common import N, RTOL, gpu, _vec, _close

pytestmark = pytest.mark.cuda


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
