"""Parity of the port's sparse formats with vexcl_tpu.

``csr``, ``ell`` and ``hyb`` are held against ``vexcl_tpu.SpMat`` in the
same format, and the port's ``sellr`` (SELL-C-sigma, built from the host
CSR) against the JAX package's CSR result and, at one shape of
tests/test_shuffle_spmv.py, against its shuffle-routed SELLR.  Also: the
ELL width rule, the format policy for CUDA decided on the CPU, SpMatCCSR
on its cached, uncached and general paths, the carry-across constructors
from the JAX package's state, and rectangular, empty and duplicate cases.

Tolerances: f64 1e-12 and f32 3e-5, relative to the largest magnitude
(sums in another order).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.sparse.formats import choose_ell_width as jax_ell_width
from vexcl_tpu.sparse.shuffle import SELLR as JaxSELLR
from vexcl_tpu.utils.poisson import poisson_7pt, poisson_7pt_ccsr
from vexcl_tpu_torch.sparse import (CSR, ELL, SELLR, Hybrid, SpMatCCSR,
                                    choose_ell_width, default_format)
from vexcl_tpu_torch.sparse.cuda_sell import (C, PACKET, ROW_BLOCK_ENTRIES,
                                              ROW_BLOCK_ROWS, row_blocks)
from vexcl_tpu_torch.sparse.formats import from_csr_host
from vexcl_tpu_torch.sparse.sell import LONG_ROW

FORMATS = ("csr", "ell", "hyb", "sellr")


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max(initial=0))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def random_csr(n, m, mean, seed, long_row=False, dup=False):
    """Lognormal row lengths with empty rows; optionally one row above
    the SELL spill length and duplicate (row, col) entries."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(0, rng.lognormal(np.log(mean), 0.8, n)).astype(np.int64)
    lens[::11] = 0
    if long_row and n > 2:
        lens[2] = LONG_ROW + 50
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, m, int(ptr[-1]))
    if dup:
        col[1::2] = col[0::2][:len(col[1::2])]
    return ptr, col, rng.standard_normal(int(ptr[-1]))


def _pair(ctx1, tctx, n, m, ptr, col, val, fmt, jfmt=None, dt=np.float64):
    jA = vex.SpMat(n, m, ptr, col, val.astype(dt), fmt=jfmt or fmt,
                   context=ctx1)
    tA = vt.SpMat(n, m, ptr, col, val.astype(dt), fmt=fmt, context=tctx)
    return jA, tA


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(2000, 2000, 8), (700, 1500, 5),
                                   (1500, 300, 12), (40, 40, 3)])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_format_matches_jax(ctx1, tctx, fmt, shape, dt):
    n, m, mean = shape
    ptr, col, val = random_csr(n, m, mean, seed=n + m, long_row=True)
    jA, tA = _pair(ctx1, tctx, n, m, ptr, col, val, fmt,
                   jfmt="csr" if fmt == "sellr" else None, dt=dt)
    assert tA.device.format == fmt and tA.nnz == jA.nnz
    hx = np.random.default_rng(61).standard_normal(m).astype(dt)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    rtol = 1e-12 if dt == np.float64 else 3e-5
    ty = vt.vector(n, dtype=dt, context=tctx)
    ty[:] = tA * tx
    assert ty.dtype == vt.dtype_of(dt)
    _close(ty, vex.eval(jA * jx), rtol)
    jy = vex.vector(data=hx[:n] if m >= n else np.ones(n, dt), context=ctx1)
    ty = vt.vector(data=np.asarray(jy), context=tctx)
    jy[:] = 2 * (jA * jx) + jy
    ty[:] = 2 * (tA * tx) + ty
    _close(ty, jy, rtol)
    # the size of Sum(A * x) is A's row count, also when n != m
    s_t = vt.Reductor(vt.SUM)(2 * (tA * tx))
    s_j = vex.Reductor(vex.SUM)(2 * (jA * jx))
    assert abs(s_t - s_j) <= rtol * max(1.0, abs(s_j)) * np.sqrt(n)
    if n == m:
        s_t = vt.Reductor(vt.SUM)(tx * (tA * tx))
        s_j = vex.Reductor(vex.SUM)(jx * (jA * jx))
        assert abs(s_t - s_j) <= rtol * max(1.0, abs(s_j))


def test_sellr_matches_jax_sellr(tctx):
    """The port's SELL-32-sigma against the shuffle-routed SELLR, at a
    shape of tests/test_shuffle_spmv.py."""
    rng = np.random.default_rng(1008)
    n = m = 1000
    lens = np.maximum(1, rng.poisson(8, n))
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, m, int(ptr[-1]))
    val = rng.standard_normal(int(ptr[-1]))
    x = np.random.default_rng(62).standard_normal(m)
    want = np.asarray(JaxSELLR(n, m, ptr, col, val).apply(x))
    got = SELLR(n, m, ptr, col, val, device="cpu").apply(torch.from_numpy(x))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
def test_in_place_spmv(ctx1, tctx, fmt):
    n = 900
    ptr, col, val = random_csr(n, n, 6, seed=63, long_row=True)
    jA, tA = _pair(ctx1, tctx, n, n, ptr, col, val, fmt,
                   jfmt="csr" if fmt == "sellr" else None)
    hx = np.random.default_rng(64).standard_normal(n)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    jx[:] = jA * jx
    tx[:] = tA * tx                   # the SpMV reads x before the write
    _close(tx, jx, 1e-12)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ["empty", "duplicates", "empty_rows",
                                  "no_rows"])
def test_edge_cases_match_jax(ctx1, tctx, fmt, case):
    n, m = 300, 500
    if case == "empty":
        ptr, col, val = np.zeros(n + 1, np.int64), np.zeros(0, np.int64), \
            np.zeros(0)
    elif case == "duplicates":
        ptr, col, val = random_csr(n, m, 6, seed=65, dup=True)
    elif case == "empty_rows":
        ptr, col, val = random_csr(n, m, 6, seed=66)
        lens = np.diff(ptr)
        lens[n // 3:] = 0
        keep = np.arange(len(col)) < lens[:n // 3].sum()
        ptr = np.concatenate([[0], np.cumsum(lens)])
        col, val = col[keep], val[keep]
    else:
        n = 0
        ptr, col, val = np.zeros(1, np.int64), np.zeros(0, np.int64), \
            np.zeros(0)
    hx = np.random.default_rng(67).standard_normal(m)
    tA = vt.SpMat(n, m, ptr, col, val, fmt=fmt, context=tctx)
    got = tA._matvec(torch.from_numpy(hx))
    assert got.shape == (n,) and got.dtype == torch.float64
    if n and len(col):
        jA = vex.SpMat(n, m, ptr, col, val,
                       fmt="csr" if fmt == "sellr" else fmt, context=ctx1)
        _close(got, vex.eval(jA * vex.vector(data=hx, context=ctx1)), 1e-12)
    else:
        assert not got.any()


@pytest.mark.parametrize("lens", [
    [0, 0, 0], [5], [3, 3, 3, 3], list(range(40)), [1] * 30 + [100] * 3,
    list(np.random.default_rng(68).poisson(9, 1000)),
    list(np.random.default_rng(69).lognormal(2.5, 0.8, 5000).astype(int)),
])
def test_choose_ell_width_matches_jax(lens):
    lens = np.asarray(lens, dtype=np.int64)
    assert choose_ell_width(lens) == jax_ell_width(lens)


def test_format_policy(tctx):
    """CPU and CUDA contexts get CSR (the row-block kernel is faster on
    the card than SELL-R), banded matrices DIA: the CUDA decision is a
    function of the device type, checked here without a card."""
    assert default_format("cpu") == "csr"
    assert default_format("cuda") == "csr"
    with pytest.raises(NotImplementedError):
        default_format("mps")
    n = 500
    ptr, col, val = random_csr(n, n, 6, seed=70)
    for dt in (np.float32, np.float64):
        assert vt.SpMat(n, n, ptr, col, val.astype(dt),
                        context=tctx).device.format == "csr"
    P = vt.SpMat(512, 512, *poisson_7pt(8), context=tctx)
    assert P.device.format == "dia"
    A = vt.matrix(n, n, ptr, col, val, context=tctx)
    assert A.device.format == "csr"
    with pytest.raises(ValueError):
        vt.SpMat(n, n, ptr, col, val, fmt="coo", context=tctx)
    bad = col.copy()
    bad[3] = n
    with pytest.raises(ValueError):
        vt.SpMat(n, n, ptr, bad, val, fmt="sellr", context=tctx)


def _check_plan(ptr, blocks, nrows):
    """Every stored row in exactly one block, blocks in row order; at
    most ROW_BLOCK_ROWS rows and fewer than ROW_BLOCK_ENTRIES entries a
    block, unless the block is one row."""
    ptr = np.asarray(ptr, np.int64)
    b = np.asarray(blocks)
    assert b.dtype == np.int32 and len(ptr) == nrows + 1
    assert b[0] == 0 and b[-1] == nrows
    rows = np.diff(b)
    assert np.all(rows > 0) and np.all(rows <= ROW_BLOCK_ROWS)
    entries = ptr[b[1:]] - ptr[b[:-1]]
    assert np.all((entries < ROW_BLOCK_ENTRIES) | (rows == 1))
    return b


def _plan_product(ptr, col, val, x, blocks):
    """y = A x computed block by block as the CSR kernel walks the plan:
    each block's products from its own run of entries, rows summed from
    there."""
    y = np.zeros(len(ptr) - 1)
    for r0, r1 in zip(blocks[:-1], blocks[1:]):
        e0 = ptr[r0]
        prod = val[e0:ptr[r1]] * x[col[e0:ptr[r1]]]
        for r in range(r0, r1):
            y[r] = prod[ptr[r] - e0:ptr[r + 1] - e0].sum()
    return y


@pytest.mark.parametrize("case", ["lognormal", "long_rows", "short_rows",
                                  "empty_rows", "empty", "no_rows",
                                  "one_row"])
def test_csr_row_block_plan(tctx, case):
    rng = np.random.default_rng(80)
    n, m = 3000, 4000
    if case == "lognormal":
        ptr, col, val = random_csr(n, m, 16, seed=81)
    elif case == "long_rows":
        lens = rng.poisson(20, n)
        lens[[5, 6, 1000]] = [ROW_BLOCK_ENTRIES // 2 + 1, 5 * ROW_BLOCK_ENTRIES,
                              ROW_BLOCK_ENTRIES - 1]
        ptr = np.concatenate([[0], np.cumsum(lens)])
        col = rng.integers(0, m, ptr[-1])
        val = rng.standard_normal(ptr[-1])
    elif case == "short_rows":
        ptr = np.arange(n + 1, dtype=np.int64)       # one entry a row
        col, val = rng.integers(0, m, n), rng.standard_normal(n)
    elif case == "empty_rows":
        ptr, col, val = random_csr(n, m, 6, seed=82)
        ptr[n // 2:] = ptr[n // 2]                   # the second half empty
        col, val = col[:ptr[-1]], val[:ptr[-1]]
    elif case == "empty":
        ptr, col, val = np.zeros(n + 1, np.int64), np.zeros(0, np.int64), \
            np.zeros(0)
    elif case == "no_rows":
        n = 0
        ptr, col, val = np.zeros(1, np.int64), np.zeros(0, np.int64), \
            np.zeros(0)
    else:
        n = 1
        ptr, col = np.array([0, 70]), rng.integers(0, m, 70)
        val = rng.standard_normal(70)
    A = CSR(n, m, ptr, col, val, device=tctx.device)
    b = _check_plan(ptr, A.blocks.numpy(), n)
    assert len(b) - 1 >= -(-n // ROW_BLOCK_ROWS)
    assert np.array_equal(b, row_blocks(ptr))
    x = rng.standard_normal(m)
    want = A.apply(torch.from_numpy(x)).numpy()
    _close(_plan_product(ptr, col, val, x, b), want, 1e-12)


@pytest.mark.parametrize("fmt", ["hyb", "sellr"])
def test_csr_tail_row_block_plan(tctx, fmt):
    """The hybrid tail and the SELL long-row tail carry a plan over their
    own stored rows (a subset of the matrix's, named by ``rows``)."""
    n = 3000
    ptr, col, val = random_csr(n, n, 9, seed=83, long_row=True)
    ptr = ptr.copy()
    lens = np.diff(ptr)
    lens[[10, 11, 12]] = [LONG_ROW + 1, 3 * ROW_BLOCK_ENTRIES, 0]
    ptr = np.concatenate([[0], np.cumsum(lens)])
    rng = np.random.default_rng(84)
    col, val = rng.integers(0, n, ptr[-1]), rng.standard_normal(ptr[-1])
    A = from_csr_host(n, n, ptr, col, val, fmt, device=tctx.device)
    T = A.tail
    nrows = T.rows.numel()
    b = _check_plan(T.ptr.numpy(), T.blocks.numpy(), nrows)
    assert np.all(np.diff(T.rows.numpy()) > 0)
    if fmt == "sellr":
        assert T.rows.tolist() == np.flatnonzero(lens > LONG_ROW).tolist()
        assert {2, 10, 11} <= set(T.rows.tolist())
    x = rng.standard_normal(n)
    got = np.zeros(n)
    got[T.rows.numpy()] = _plan_product(T.ptr.numpy(), T.col.numpy(),
                                        T.val.numpy(), x, b)
    want = T.apply(torch.from_numpy(x),
                   out=torch.zeros(n, dtype=torch.float64)).numpy()
    _close(got, want, 1e-12)


def _rows_of_planes(A):
    """Each stored row's slots, read back from the packet layout: slice s
    is a (w / 4, 32, 4) plane from slice_ptr[s], packet k of lane l holding
    slots 4k .. 4k + 3 of the slice's row l.  Returns (cols, vals), lists
    of one array of w slots per stored row."""
    sp = A.slice_ptr.numpy()
    pc, pv = A.col.numpy(), A.val.numpy()
    assert np.all(sp % (PACKET * C) == 0)
    cols, vals = [], []
    for s in range(len(sp) - 1):
        w = (sp[s + 1] - sp[s]) // C
        assert w % PACKET == 0

        def plane(a):
            return a[sp[s]:sp[s + 1]].reshape(w // PACKET, C, PACKET) \
                .transpose(1, 0, 2).reshape(C, w)
        cols += list(plane(pc))
        vals += list(plane(pv))
    return cols, vals


def test_sell_layout(tctx):
    """The packet layout of SELLR: rows sorted by length in sigma windows,
    slices of 32 rows at a width that is a multiple of 4 (and less than 4
    over the slice's longest row), each row's first entries in order in
    its lane's packets, padding slots with column -1 and value 0, the rows
    over the spill length in the CSR tail."""
    n = 3000
    ptr, col, val = random_csr(n, n, 9, seed=71, long_row=True)
    A = SELLR(n, n, ptr, col, val, device=tctx.device)
    lens = np.diff(ptr)
    long = np.flatnonzero(lens > LONG_ROW)
    assert A.tail is not None and A.tail.rows.tolist() == long.tolist()
    assert 2 in long
    perm = A.perm.numpy()
    assert sorted(perm.tolist()) == list(range(n))
    sl = np.where(lens > LONG_ROW, 0, lens)[perm]
    assert np.all(np.diff(sl) <= 0)              # one window at n = 3000
    sp = A.slice_ptr.numpy()
    assert len(sp) == -(-n // C) + 1
    cols, vals = _rows_of_planes(A)
    assert len(cols) == len(sp[:-1]) * C
    for r in range(len(cols)):
        w = len(cols[r])
        top = sl[r // C * C:(r // C + 1) * C].max()
        assert top <= w < top + PACKET
        k = sl[r] if r < n else 0
        if r < n:
            e = ptr[perm[r]]
            assert np.array_equal(cols[r][:k], col[e:e + k])
            assert np.array_equal(vals[r][:k], val[e:e + k])
        assert np.all(cols[r][k:] == -1) and np.all(vals[r][k:] == 0)
    assert int((A.col >= 0).sum()) + A.tail.nnz == A.nnz
    assert A.slots < 1.3 * A.nnz


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
@pytest.mark.parametrize("n, mean", [(777, 5), (64, 3), (1000, 9)])
def test_from_jax_leaves_packet_layout(ctx1, tctx, fmt, n, mean):
    """The JAX package's row-major (n, w) ELL planes, and the hybrid's ELL
    part with its tail, carried into the packet layout: every row's slots
    where the kernel reads them (w rounded up to a multiple of 4, n not a
    multiple of 32), and the product of vexcl_tpu's matrix."""
    ptr, col, val = random_csr(n, n, mean, seed=n + mean)
    jd = vex.SpMat(n, n, ptr, col, val, fmt=fmt, context=ctx1).device
    leaves = [np.asarray(a) for a in jd.leaves()]
    cls = ELL if fmt == "ell" else Hybrid
    td = cls.from_arrays(n, n, *leaves, device=tctx.device)
    ell_col, ell_val = leaves[0].reshape(n, -1), leaves[1].reshape(n, -1)
    w = ell_col.shape[1]
    assert td.width == w and td.perm is None and td.nnz == jd.nnz
    cols, vals = _rows_of_planes(td)
    w4 = -(-w // PACKET) * PACKET
    assert all(len(c) == w4 for c in cols) and len(cols) == -(-n // C) * C
    for r in range(len(cols)):
        want_c = ell_col[r] if r < n else np.full(w, -1)
        want_v = ell_val[r] if r < n else np.zeros(w)
        assert np.array_equal(cols[r][:w], want_c)
        assert np.array_equal(vals[r][:w], want_v)
        assert np.all(cols[r][w:] == -1) and np.all(vals[r][w:] == 0)
    assert (td.tail is not None) == (len(leaves) > 2 and len(leaves[2]) > 0)
    hx = np.random.default_rng(77).standard_normal(n)
    _close(td.apply(torch.from_numpy(hx)), np.asarray(jd.apply(hx)), 1e-12)


@pytest.mark.parametrize("cache", [None, False])
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ccsr_matches_jax(ctx1, tctx, cache, dt):
    m = 12
    idx, row, col, val = poisson_7pt_ccsr(m, dtype=dt)
    jA = vex.SpMatCCSR(m ** 3, m ** 3, idx, row, col, val, context=ctx1,
                       cache_expansion=cache)
    tA = vt.SpMatCCSR(m ** 3, m ** 3, idx, row, col, val, context=tctx,
                      cache_expansion=cache)
    assert (tA.cached_coeffs is None) == (jA._cached_coeffs is None)
    if cache is None:
        assert str(tA.cached_coeffs.dtype).endswith(
            str(jA._cached_coeffs.dtype))
    assert tA.offset_union == jA.offset_union and tA.width == jA.width
    assert tA.nnz == jA.nnz and str(tA.dtype).endswith(str(jA.dtype))
    hx = np.random.default_rng(72).random(m ** 3).astype(dt)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    rtol = 1e-12 if dt == np.float64 else 3e-5
    _close(vt.eval(tA * tx), vex.eval(jA * jx), rtol)
    # the same values as the DIA SpMat of the CSR Poisson matrix
    P = vt.SpMat(m ** 3, m ** 3, *poisson_7pt(m, dtype=dt), context=tctx)
    _close(vt.eval(tA * tx), vt.eval(P * tx), rtol)


def test_ccsr_general_path_matches_jax(ctx1, tctx):
    """More than 64 distinct offsets: the gather over per-row patterns."""
    rng = np.random.default_rng(73)
    n, nuniq, width = 2000, 6, 24
    idx = rng.integers(0, nuniq, n).astype(np.int32)
    lens = rng.integers(width // 2, width + 1, nuniq)
    row = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(-300, 300, int(row[-1])).astype(np.int32)
    val = rng.standard_normal(int(row[-1]))
    jA = vex.SpMatCCSR(n, n, idx, row, col, val, context=ctx1)
    tA = vt.SpMatCCSR(n, n, idx, row, col, val, context=tctx)
    assert tA.offset_union is None and jA.offset_union is None
    hx = rng.standard_normal(n)
    _close(vt.eval(tA * vt.vector(data=hx, context=tctx)),
           vex.eval(jA * vex.vector(data=hx, context=ctx1)), 1e-12)


def test_carry_across_from_jax_state(ctx1, tctx):
    """CSR, ELL, Hybrid and SpMatCCSR built from the JAX objects' state
    give the JAX package's products."""
    n, m = 800, 900
    ptr, col, val = random_csr(n, m, 7, seed=74, long_row=True)
    hx = np.random.default_rng(75).standard_normal(m)
    x = torch.from_numpy(hx)
    for fmt, cls in (("csr", CSR), ("ell", ELL), ("hyb", Hybrid)):
        jd = vex.SpMat(n, m, ptr, col, val, fmt=fmt, context=ctx1).device
        td = cls.from_arrays(n, m, *[np.asarray(a) for a in jd.leaves()],
                             device=tctx.device)
        assert td.nnz == jd.nnz
        _close(td.apply(x), np.asarray(jd.apply(hx)), 1e-12)
    mm = 10
    idx, row, ccol, cval = poisson_7pt_ccsr(mm, dtype=np.float32)
    for cache in (None, False):
        jA = vex.SpMatCCSR(mm ** 3, mm ** 3, idx, row, ccol, cval,
                           context=ctx1, cache_expansion=cache)
        tA = SpMatCCSR.from_arrays(
            mm ** 3, mm ** 3, *[np.asarray(a) for a in jA._leaves],
            jA.offset_union, np.asarray(jA._union_table_dev),
            None if jA._cached_coeffs is None
            else np.asarray(jA._cached_coeffs), context=tctx)
        if cache is None:
            assert tA.cached_coeffs.dtype == torch.bfloat16
        hx = np.random.default_rng(76).random(mm ** 3).astype(np.float32)
        _close(vt.eval(tA * vt.vector(data=hx, context=tctx)),
               vex.eval(jA * vex.vector(data=hx, context=ctx1)), 3e-5)
