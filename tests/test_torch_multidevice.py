"""Contexts of several parts in the port against vexcl_tpu's 8-device mesh.

The JAX package partitions through GSPMD over the suite's 8 virtual CPU
devices (the ``ctx`` fixture of tests/conftest.py); the port holds one
tensor a part, in contexts of 3, 4 and 8 parts on the CPU
(``Context(devices=["cpu"] * D)``, the reference's duplicated queue).  The
same seeded numpy inputs go through both:

* partition points (weighted, uneven, n < D, n = 0) against
  ``vexcl_tpu.parallel.partition.partition_points``, and the freeze of
  ``set_partitioning``;
* expressions, ``tie`` and ``element_index`` with the counter-based
  generators: f64 within 1e-12 of vexcl_tpu, and bit for bit the port's
  one-part result;
* the Reductor's SUM, MIN and MAX with a NaN: f64 1e-12, f32 1e-5;
* stencils of 5 and 255 taps, parts shorter than the halo too: 1e-12,
  and bit for bit one part;
* ``distributed`` in each exchange, and ``SpMat`` over parts, against
  ``vexcl_tpu.sparse.distributed`` and ``SpMat`` on ``ctx``: 1e-12;
* inclusive and exclusive scans with ``init`` (add, max, min): 1e-12;
* ``interop.cg`` on the 16^3 Poisson matrix: x within 1e-10 of the JAX
  solve (f64);
* every operation that is not partition-aware raises NotImplementedError
  naming itself, and no module of the port imports jax or vexcl_tpu
  (sort, the FFT, the keyed scans, reduce_by_key and any_of/all_of run
  over parts: ``tests/test_torch_multidevice_algorithms.py``).

Tolerances are relative to the largest magnitude of the JAX result.
"""

import ast
import itertools
import os

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.parallel.partition import partition_points as jax_points
from vexcl_tpu.utils.poisson import poisson_7pt
from vexcl_tpu_torch.models import PoissonSolver
from vexcl_tpu_torch.parallel import partition as tpart
from vexcl_tpu_torch.sparse.distributed import distributed as tdist

PARTS = [3, 4, 8]

#: vexcl_tpu's results, kept across a module's cases (each JAX program
#: compiles once)
_JAX: dict = {}


def _jax_once(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


@pytest.fixture(scope="module")
def tctx1():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _ctx(parts):
    return vt.Context(devices=["cpu"] * parts, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max(1.0, np.abs(want[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rtol * scale)


def _jv(ctx, a):
    return vex.vector(data=a, context=ctx)


def _tv(ctx, a):
    return vt.vector(data=a, context=ctx)


# -- partition points ----------------------------------------------------

@pytest.mark.parametrize("n,parts,weights", [
    (100, 4, None), (101, 3, None), (10, 4, None), (3, 8, None),
    (0, 4, None), (1, 3, None), (100, 4, [1, 1, 2, 4]),
    (997, 8, [3, 1, 1, 1, 1, 1, 1, 5]), (5, 4, [0, 1, 1, 0])])
def test_partition_points_match_jax(n, parts, weights):
    w = None if weights is None else np.asarray(weights, float)
    np.testing.assert_array_equal(tpart.partition_points(n, parts, w),
                                  jax_points(n, parts, w))
    assert tpart.shard_sizes(n, parts) == list(np.diff(jax_points(n, parts)))


@pytest.mark.parametrize("parts", PARTS)
def test_weighted_parts_hold_their_points(parts):
    """A weight function moves the points and the placement; ``map(part)``
    and the part tensors follow them; the policy freezes at the first
    partition (vector.hpp:95-104).  The parts share one device, so the
    weight function tells them apart by counting its calls (one a part,
    in order)."""
    tpart.reset_partitioning()
    try:
        weights = np.arange(1, parts + 1, dtype=float)
        calls = itertools.count()
        vt.set_partitioning(lambda dev: weights[next(calls) % parts])
        ctx = _ctx(parts)
        n = 1000
        v = vt.vector(data=np.arange(n, dtype=np.float64), context=ctx)
        pts = v.partition()
        np.testing.assert_array_equal(pts, jax_points(n, parts, weights))
        assert [p.shape[0] for p in v.parts] == list(np.diff(pts))
        for d in range(parts):
            np.testing.assert_array_equal(v.map(d),
                                          np.arange(pts[d], pts[d + 1]))
        with v.map(1) as m:
            m[:] = -1
        assert (v.to_numpy()[pts[1]:pts[2]] == -1).all()
        y = vt.vector(n, dtype=np.float64, context=ctx)
        y[:] = 2 * v + 1
        assert y.to_numpy()[pts[1]] == -1.0 and y[0] == 1.0
        with pytest.raises(RuntimeError):
            vt.set_partitioning(lambda dev: 1.0)
    finally:
        tpart.reset_partitioning()


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", [0, 2, 13, 1000])
def test_vector_host_transfers_and_scalars(parts, n):
    ctx = _ctx(parts)
    a = np.random.default_rng(n).standard_normal(n)
    v = _tv(ctx, a)
    assert v.nparts == parts and v.size == n and len(v) == n
    np.testing.assert_array_equal(v.to_numpy(), a)
    c = v.copy()
    if n:
        v[n - 1] = 7.0
        assert v[n - 1] == 7.0 and c[n - 1] == a[n - 1]
        v.write_data(np.full(min(n, 5), 3.0), offset=n // 2 - n // 4)
        want = a.copy()
        want[n - 1] = 7.0
        want[n // 2 - n // 4:n // 2 - n // 4 + min(n, 5)] = 3.0
        np.testing.assert_array_equal(v.to_numpy(), want)
    np.testing.assert_array_equal(c.to_numpy(), a)
    z = vt.vector(n, dtype=np.int32, context=ctx, fill=4)
    assert z.dtype == torch.int32 and (z.to_numpy() == 4).all()


# -- expressions ---------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("n", [5, 1001])
def test_expressions_match_jax(ctx, tctx1, rng, parts, n):
    a, b, c = (rng.standard_normal(n) for _ in range(3))
    tc = _ctx(parts)

    def expr(m, x, y, z):
        return 2 * x + m.sin(y) * z - m.element_index() * 0.5 + a

    jx, jy, jz = (_jv(ctx, t) for t in (a, b, c))
    want = np.asarray(vex.eval(expr(vex, jx, jy, jz)))
    for cx in (tc, tctx1):
        tx, ty, tz = (_tv(cx, t) for t in (a, b, c))
        out = vt.vector(n, dtype=np.float64, context=cx)
        out[:] = expr(vt, tx, ty, tz)
        out += tx * ty
        got = out.to_numpy()
        if cx is tc:
            parted = got
    _close(parted, want + a * b, 1e-12)
    np.testing.assert_array_equal(parted, got)      # one part, bit for bit
    # tie: two targets in one kernel a part, the swap
    tx, ty = _tv(tc, a), _tv(tc, b)
    vt.tie(tx, ty)[:] = (ty + 1, tx * 2)
    np.testing.assert_array_equal(tx.to_numpy(), b + 1)
    np.testing.assert_array_equal(ty.to_numpy(), a * 2)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("gen", ["philox", "threefry"])
@pytest.mark.parametrize("normal", [False, True])
def test_random_over_parts_bitwise(ctx, tctx1, parts, gen, normal):
    """``x[:] = rnd(element_index(), seed)``: the index stays global, so
    the parts give the one-part stream bit for bit, and vexcl_tpu's."""
    n = 1003
    make = (vt.RandomNormal if normal else vt.Random)(np.float64, gen)
    out = {}
    for cx in (_ctx(parts), tctx1):
        x = vt.vector(n, dtype=np.float64, context=cx)
        x[:] = make(vt.element_index(), 11)
        out[cx.size] = x.to_numpy()
    np.testing.assert_array_equal(out[parts], out[1])
    jm = (vex.RandomNormal if normal else vex.Random)(np.float64, gen)
    jx = vex.vector(n, dtype=np.float64, context=ctx)
    jx[:] = jm(vex.element_index(), 11)
    _close(out[parts], np.asarray(jx), 1e-12)


# -- the Reductor ----------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [3, 1000])
def test_reductor_matches_jax(ctx, ctx1, rng, parts, dt, n):
    """With a NaN, MIN and MAX are held against vexcl_tpu on one device:
    on its mesh a shard's NaN is dropped by the cross-device pmin/pmax
    (ROADMAP.md §3, reference-side faults)."""
    a = rng.standard_normal(n).astype(dt)
    b = rng.standard_normal(n).astype(dt)
    tol = 1e-12 if dt == np.float64 else 1e-5
    tc = _ctx(parts)
    for nan in (False, True):
        if nan:
            a[n // 2] = np.nan
        jc = ctx1 if nan else ctx
        for kind in ("SUM", "MIN", "MAX"):
            want = vex.Reductor(getattr(vex, kind))(_jv(jc, a) * _jv(jc, b))
            got = vt.Reductor(getattr(vt, kind))(_tv(tc, a) * _tv(tc, b))
            _close(np.float64(got), np.float64(want), tol if kind == "SUM"
                   else 0)
        mm = vt.Reductor(vt.MIN_MAX)(_tv(tc, a))
        jmm = vex.Reductor(vex.MIN_MAX)(_jv(jc, a))
        _close(np.array(mm, np.float64), np.array(jmm, np.float64), 0)


# -- stencils --------------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("width,center", [(5, 2), (255, 100), (4, 0)])
@pytest.mark.parametrize("n", [7, 300, 2000])
def test_stencil_matches_jax(ctx, ctx1, tctx1, parts, width, center, n):
    """Parts shorter than the halo (n = 7, 300 at 255 taps) too.  The
    255-tap stencil is held against vexcl_tpu on one device: its mesh
    program with halos wider than the shards takes 30-115 s to compile on
    the CPU."""
    rng = np.random.default_rng(width * 7 + n)
    a = rng.standard_normal(n)
    taps = rng.standard_normal(width)
    jc = ctx1 if width > 5 else ctx
    want = _jax_once(("stencil", width, center, n), lambda: np.asarray(
        vex.eval(_jv(jc, a) * vex.stencil(taps, center))))
    got = {}
    for cx in (_ctx(parts), tctx1):
        x = _tv(cx, a)
        y = vt.vector(n, dtype=np.float64, context=cx)
        y[:] = x * vt.stencil(taps, center) + x
        x[:] = x * vt.stencil(taps, center)      # in place: the old x
        got[cx.size] = (y.to_numpy(), x.to_numpy())
    _close(got[parts][1], want, 1e-12)
    _close(got[parts][0], want + a, 1e-12)
    np.testing.assert_array_equal(got[parts][0], got[1][0])
    np.testing.assert_array_equal(got[parts][1], got[1][1])


@pytest.mark.parametrize("parts", PARTS)
def test_stencil_operator_over_parts(ctx, parts):
    n = 203
    a = np.random.default_rng(3).standard_normal(n)

    def body(X):
        return X[0] + (X[-1] + X[1]) ** 3

    want = np.asarray(vex.eval(vex.StencilOperator(3, 1, body)(_jv(ctx, a))))
    y = vt.vector(n, dtype=np.float64, context=_ctx(parts))
    y[:] = vt.StencilOperator(3, 1, body)(_tv(y.context, a))
    _close(y.to_numpy(), want, 1e-12)


# -- the distributed SpMV, SpMat and CG --------------------------------------

def _csr(rng, n, m, per_row, band=None):
    rng = np.random.default_rng(n * 31 + per_row)
    """A random CSR matrix: ``per_row`` entries a row, in a band of
    ``band`` columns around the diagonal where it is given."""
    rows, cols = [], []
    for i in range(n):
        if band is None:
            c = rng.choice(m, size=min(per_row, m), replace=False)
        else:
            lo, hi = max(0, i - band), min(m, i + band + 1)
            c = rng.choice(np.arange(lo, hi), size=min(per_row, hi - lo),
                           replace=False)
        cols.append(np.sort(c))
        rows.append(len(c))
    ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    col = np.concatenate(cols).astype(np.int32)
    return ptr, col, rng.standard_normal(len(col))


MATRICES = {"poisson": None, "band": (600, 600, 6, 20),
            "dense": (300, 300, 40, None), "rect": (250, 170, 5, None)}


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("mode", ["dia_halo", "ell_a2a", "ell_allgather"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_distributed_matches_jax(ctx, rng, parts, mode, matrix):
    if matrix == "poisson":
        # 10^3 rows: the band of 100 lies within a part of 8 (125 rows)
        ptr, col, val = poisson_7pt(10, dtype=np.float64)
        n = m = 1000
    else:
        n, m, per, band = MATRICES[matrix]
        ptr, col, val = _csr(rng, n, m, per, band)
    tc = _ctx(parts)
    if mode == "dia_halo" and matrix != "poisson":
        with pytest.raises(ValueError):
            tdist(n, m, ptr, col, val, context=tc, mode=mode)
        return
    A = tdist(n, m, ptr, col, val, context=tc, mode=mode)
    assert A.mode == mode
    a = np.random.default_rng(m).standard_normal(m)
    want = _jax_once(("dist", matrix), lambda: np.asarray(vex.eval(
        vex.sparse.distributed(n, m, ptr, col, val, context=ctx)
        * _jv(ctx, a))))
    x = _tv(tc, a)
    y = vt.vector(n, dtype=np.float64, context=tc)
    y[:] = A * x
    _close(y.to_numpy(), want, 1e-12)
    y[:] = 0.5 * (A * (x * 2)) + y                # x an expression
    _close(y.to_numpy(), 2 * want, 1e-12)


@pytest.mark.parametrize("parts", PARTS)
def test_distributed_chooses_as_jax(ctx, rng, parts):
    """The exchange chosen by the matrix: banded, sparse coupling (ghost
    sets), dense coupling (the whole x), more than 2^22 entries aside."""
    tc = _ctx(parts)
    ptr, col, val = poisson_7pt(10, dtype=np.float64)
    assert tdist(1000, 1000, ptr, col, val, context=tc).mode == "dia_halo"
    # a band wider than a part leaves dia_halo, as in the JAX package
    ptr, col, val = poisson_7pt(8, dtype=np.float64)
    wide = tdist(512, 512, ptr, col, val, context=_ctx(8)).mode
    assert wide != "dia_halo"
    ptr, col, val = _csr(rng, 2048, 2048, 4, 60)
    assert tdist(2048, 2048, ptr, col, val, context=tc).mode == "ell_a2a"
    ptr, col, val = _csr(rng, 300, 300, 40)
    assert tdist(300, 300, ptr, col, val, context=tc).mode == \
        "ell_allgather"


@pytest.mark.parametrize("parts", PARTS)
def test_sellr_is_a_name_for_the_gathered_x(rng, parts):
    """``mode="sellr"`` (the JAX package's SELL-R local phase over the
    gathered x) stores ``ell_allgather`` and gives its bits."""
    tc = _ctx(parts)
    ptr, col, val = _csr(rng, 250, 170, 5)
    a = np.random.default_rng(1).standard_normal(170)
    ys = []
    for mode in ("sellr", "ell_allgather"):
        A = tdist(250, 170, ptr, col, val, context=tc, mode=mode)
        assert A.mode == "ell_allgather"
        y = vt.vector(250, dtype=np.float64, context=tc)
        y[:] = A * _tv(tc, a)
        ys.append(y.to_numpy())
    np.testing.assert_array_equal(ys[0], ys[1])


def test_more_than_2_22_entries_gather_x_without_ghost_sets(monkeypatch):
    """Past 2^22 entries the matrix takes the gathered x without building
    the ghost sets (the JAX package's SELL-R choice)."""
    def no_ghosts(*args):
        raise AssertionError("ghost sets built")

    monkeypatch.setattr(tdist, "_ghost_sets", no_ghosts)
    n, per = 1 << 16, 65                     # 2^22 + 2^16 entries
    ptr = np.arange(n + 1, dtype=np.int64) * per
    col = np.random.default_rng(0).integers(0, n, n * per).astype(np.int32)
    A = tdist(n, n, ptr, col, np.ones(n * per, np.float32),
              context=_ctx(4), banded=False)
    assert A.mode == "ell_allgather"


@pytest.mark.parametrize("parts", PARTS)
def test_spmat_over_parts_matches_jax(ctx, rng, parts):
    tc = _ctx(parts)
    ptr, col, val = poisson_7pt(10, dtype=np.float64)
    n = 1000
    for fmt in (None, "csr", "dia", "sellr"):
        A = vt.SpMat(n, n, ptr, col, val, context=tc, fmt=fmt)
        assert A.device.mode in {None: ("dia_halo",), "dia": ("dia_halo",),
                                 "sellr": ("ell_allgather",)}.get(
            fmt, ("ell_a2a", "ell_allgather"))
        JA = vex.SpMat(n, n, ptr, col, val, context=ctx)
        a = rng.standard_normal(n)
        want = np.asarray(vex.eval(JA * _jv(ctx, a)))
        y = vt.vector(n, dtype=np.float64, context=tc)
        y[:] = A * _tv(tc, a) - 1
        _close(y.to_numpy(), want - 1, 1e-12)


@pytest.mark.parametrize("parts", PARTS)
def test_cg_over_parts_matches_jax(ctx, rng, parts):
    """``interop.cg`` on 16^3 Poisson, f64, over parts (DIA with halos,
    the per-part Reductor) against the JAX solve on the 8-device mesh."""
    n = 16 ** 3
    ptr, col, val = poisson_7pt(16, dtype=np.float64)
    f = np.random.default_rng(16).standard_normal(n)

    def solve():
        x, it = vex.interop.cg(vex.SpMat(n, n, ptr, col, val, context=ctx),
                               _jv(ctx, f), tol=1e-10)
        return np.asarray(x), it

    jx, jit = _jax_once("cg", solve)
    tc = _ctx(parts)
    A = vt.SpMat(n, n, ptr, col, val, context=tc)
    x, it = vt.interop.cg(A, _tv(tc, f), tol=1e-10)
    assert x.nparts == parts and abs(it - jit) <= 1
    _close(x.to_numpy(), np.asarray(jx), 1e-10)
    P = PoissonSolver(10, np.float64, context=tc)
    u, _ = P.solve(f[:1000], tol=1e-10)
    assert u.nparts == parts and P.A.device.mode == "dia_halo"


# -- scans -----------------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("fn", ["inclusive_scan", "exclusive_scan"])
@pytest.mark.parametrize("op", [None, "max", "min"])
@pytest.mark.parametrize("init", [None, 1.5])
def test_scan_matches_jax(ctx, rng, parts, fn, op, init):
    n = 1001
    a = np.random.default_rng(n).standard_normal(n)
    a[400] = np.nan if op is not None else a[400]
    jop = {None: None, "max": __import__("jax").numpy.maximum,
           "min": __import__("jax").numpy.minimum}[op]
    top = {None: None, "max": torch.maximum, "min": torch.minimum}[op]
    want = _jax_once(("scan", fn, op, init), lambda: np.asarray(
        getattr(vex, fn)(_jv(ctx, a), init=init, op=jop)))
    tc = _ctx(parts)
    got = getattr(vt, fn)(_tv(tc, a), init=init, op=top)
    assert got.nparts == parts
    _close(got.to_numpy(), want, 1e-12)
    x = _tv(tc, a)                                # in place
    vt.inclusive_scan(x, x, op=top)
    _close(x.to_numpy(), _jax_once(("scan", op), lambda: np.asarray(
        vex.inclusive_scan(_jv(ctx, a), op=jop))), 1e-12)


@pytest.mark.parametrize("parts", [8])
def test_scan_over_empty_parts(parts):
    tc = _ctx(parts)
    for n in (0, 1, 3):
        a = np.arange(1, n + 1, dtype=np.float64)
        got = vt.exclusive_scan(_tv(tc, a), init=2.0).to_numpy()
        want = 2.0 + np.concatenate([[0], np.cumsum(a)[:-1]])[:n]
        np.testing.assert_array_equal(got, want)


# -- what is not partition-aware -------------------------------------------

def _ops(tc, c1):
    n = 16
    x = vt.vector(data=np.arange(n, dtype=np.float32), context=tc)
    y = vt.vector(n, dtype=np.float32, context=tc)
    idx = vt.vector(data=np.arange(n, dtype=np.int32)[::-1].copy(),
                    context=tc)
    img = vt.image2d(np.ones((4, 4), np.float32), context=c1)
    fit = vt.mba(np.zeros(2), np.ones(2), [np.random.default_rng(0).random(
        (16, 2))[:, 0], np.random.default_rng(1).random(16)],
        np.ones(16), (3, 3), levels=1)
    s = vt.symbolic()
    return {
        "MBAExpr": lambda: y.assign(fit(x, x)),
        "ImageSample": lambda: y.assign(img(x, x)),
        "SliceTerminal": lambda: y.assign(x[0:16]),
        "PermutationView": lambda: y.assign(vt.permutation(idx)(x)),
        "PointerDeref": lambda: y.assign(vt.raw_pointer(x)[idx]),
        "ReducedView": lambda: y.assign(vt.reduce_view(
            "sum", vt.reshape(x, (4, 4)), 1)),
        "assignment through a slice": lambda: y.__setitem__(idx, x),
        "atomic_add": lambda: vt.atomic_add(vt.permutation(idx)(y), x),
        "gather": lambda: vt.gather(x, np.arange(3)),
        "scatter": lambda: vt.scatter(np.ones(3), np.arange(3), y),
        "Kernel.as_function": lambda: vt.generator.Kernel(
            "k", [s], [s]).as_function()(x),
        "enqueue": lambda: vt.enqueue(c1)(y).assign(x * 2),
        "CustomKernel": lambda: vt.CustomKernel(
            'extern "C" __global__ void k(float *x) {}')(x),
    }


OPS = ["MBAExpr", "ImageSample", "SliceTerminal", "PermutationView",
       "PointerDeref", "ReducedView", "assignment through a slice",
       "atomic_add", "gather", "scatter", "Kernel.as_function", "enqueue",
       "CustomKernel"]


@pytest.mark.parametrize("op", OPS)
def test_not_partition_aware_raises_naming_itself(tctx1, op):
    """Each operation the per-part path does not cover raises
    NotImplementedError naming itself on a vector of 4 parts; none
    computes on one part."""
    tc = _ctx(4)
    with pytest.raises(NotImplementedError, match=op.split()[0]):
        _ops(tc, tctx1)[op]()


def test_storage_of_a_partitioned_vector_raises_outside_the_evaluator():
    v = vt.vector(10, context=_ctx(3))
    with pytest.raises(NotImplementedError, match="not partition-aware"):
        v.storage
    with pytest.raises(ValueError):
        vt.vector(10, context=_ctx(4))[:] = v       # another partition


def test_port_imports_neither_jax_nor_vexcl_tpu():
    root = os.path.dirname(vt.__file__)
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                bad += [(path, m) for m in names
                        if m.split(".")[0] in ("jax", "jaxlib", "vexcl_tpu")]
    assert not bad
