"""Assignment through a permutation in the port (``ops/cuda_scatter.py``)
against vexcl_tpu, on the CPU.

The same numpy inputs (from a seed) go through the JAX package's
permutation assignment and atomics (``permutation(p)(y).assign(v)``,
``atomic_add/min/max``), through the port's API (on the CPU its plain
version, ``assign_to_view_plain``), and through the CPU mirror of the
CUDA scatter's range plan (``ranges_mirror``: the (tile, range) counts,
their range-major scan, the stable distribution into pairs and the
build, at small ranges and tiles so that a case spans many of each,
ragged last ones included).  The operands the route hands the kernels
(``triton_emit._scatter_operands``: a leaf read as it is, or one K1
evaluation of an index or value expression) are held the same way.
``route`` is checked as a pure function, and against the choices its
thresholds were set from (``scripts/torch_scatter_turns.py --sweep``).

Tolerances: exact (stores, integer add, min, max), except float add:
1e-12 (f64) and 1e-6 (f32) relative to the largest magnitude (another
summation order).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.expr.compile import prepare_view_assign
from vexcl_tpu_torch.expr.triton_emit import _scatter_operands
from vexcl_tpu_torch.ops import cuda_scatter as cs

TYPES = [np.float32, np.float64, np.int32, np.int64]
MODES = ["store", "add", "min", "max"]
RTOL = {np.float32: 1e-6, np.float64: 1e-12}

#: small plans: (range bytes, tile) so that a case spans many of each
PLANS = [(64, 700), (512, 4096), (1 << 17, 333)]


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _check(got, want, dt, mode):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "add" and dt in RTOL:
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL[dt] * scale)
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(seed, dt, target, n, mode, spill=0, idt=np.int32):
    """(target, index, values): a permutation prefix for stores, repeated
    indices else; ``spill`` of them negative or out of range (each
    wrapped negative meets no twin under a store)."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dt, np.floating):
        hy = (rng.standard_normal(target) * 10).astype(dt)
        hv = (rng.standard_normal(n) * 10).astype(dt)
    else:
        hy = rng.integers(-100, 100, target).astype(dt)
        hv = rng.integers(-100, 100, n).astype(dt)
    if mode == "store":
        hp = rng.permutation(max(target, n))[:n] % target
        if n > target:
            hp = rng.permutation(target)[:n]
            hv = hv[:hp.size]
    else:
        hp = rng.integers(0, target, n)
    if spill:
        at = rng.choice(hp.size, spill, replace=False)
        for a in at:
            if rng.random() < 0.5 or mode != "store":
                hp[a] = rng.choice([target, target + 5, -target - 1,
                                    3 * target])
            else:
                hp[a] -= target        # wraps back to itself
    return hy, hp.astype(idt), hv


def _jax_run(ctx1, hy, hp, value, mode):
    jy = vex.vector(data=hy.copy(), context=ctx1)
    jp = vex.vector(data=hp, context=ctx1)
    if mode == "store":
        vex.permutation(jp)(jy).assign(value(vex, ctx1))
    else:
        vex.eval(getattr(vex, f"atomic_{mode}")(vex.permutation(jp)(jy),
                                                value(vex, ctx1)))
    return np.asarray(jy.to_numpy())


def _port_run(tctx, hy, hp, value, mode):
    ty = vt.vector(data=hy.copy(), context=tctx)
    tp = vt.vector(data=hp, context=tctx)
    if mode == "store":
        vt.permutation(tp)(ty).assign(value(vt, tctx))
    else:
        vt.eval(getattr(vt, f"atomic_{mode}")(vt.permutation(tp)(ty),
                                              value(vt, tctx)))
    return ty.to_numpy().copy(), ty, tp


def _operands(tctx, hy, hp, value, mode, monkeypatch, index=None):
    """The route's operands of the port's assignment on the CPU (the
    thresholds lowered so that it routes to form A)."""
    for name in ("RANGES_MIN_TARGET", "RANGES_MIN_UPDATES",
                 "RANGES_MIN_PER_ELEMENT", "PRIVATIZED_MAX_WINDOWS"):
        monkeypatch.setattr(cs, name, 0)
    ty = vt.vector(data=hy.copy(), context=tctx)
    tp = vt.vector(data=hp, context=tctx)
    idx = tp if index is None else index(tp)
    args = prepare_view_assign(vt.permutation(idx)(ty), value(vt, tctx),
                               atomic=None if mode == "store" else mode)
    ops = _scatter_operands(*args)
    assert ops is not None and ops[0] == "ranges"
    return ops[1:]


def _mirror(hy, idx, val, scalar, mode, range_bytes, tile):
    out = torch.from_numpy(hy.copy())
    plan = cs.range_plan(out.numel(), idx.numel(), out.element_size(),
                         range_bytes)
    plan = plan._replace(tile=tile, tiles=max(1, -(-idx.numel() // tile)))
    inter = cs.ranges_mirror(out, idx, val, mode, scalar, plan)
    return out.numpy(), inter, plan


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", TYPES)
def test_modes_and_types(ctx1, tctx, dt, mode, monkeypatch):
    """Every route mode and type: vexcl_tpu, the port's API and the
    mirror at three plans agree; n below the target length."""
    hy, hp, hv = _inputs(1, dt, 5000, 3777, mode)

    def value(pkg, c):
        return pkg.vector(data=hv, context=c)
    want = _jax_run(ctx1, hy, hp, value, mode)
    got, _, _ = _port_run(tctx, hy, hp, value, mode)
    _check(got, want, dt, mode)
    idx, val, scalar = _operands(tctx, hy, hp, value, mode, monkeypatch)
    assert scalar is None and val is not None and idx.dtype == torch.int32
    for rb, tile in PLANS:
        m, _, _ = _mirror(hy, idx, val, scalar, mode, rb, tile)
        _check(m, want, dt, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_out_of_range_and_negative(ctx1, tctx, mode, idt, monkeypatch):
    """Negative indices wrap once, the rest out of range is dropped;
    n above the target length (duplicates) for add, min and max."""
    n = 1500 if mode == "store" else 9000
    hy, hp, hv = _inputs(2, np.float64, 3001, n, mode, spill=200, idt=idt)

    def value(pkg, c):
        return pkg.vector(data=hv, context=c)
    want = _jax_run(ctx1, hy, hp, value, mode)
    got, _, _ = _port_run(tctx, hy, hp, value, mode)
    _check(got, want, np.float64, mode)
    idx, val, scalar = _operands(tctx, hy, hp, value, mode, monkeypatch)
    assert idx.dtype == (torch.int32 if idt == np.int32 else torch.int64)
    for rb, tile in PLANS:
        m, inter, plan = _mirror(hy, idx, val, scalar, mode, rb, tile)
        _check(m, want, np.float64, mode)
        j = torch.from_numpy(hp.astype(np.int64))
        j = torch.where(j < 0, j + 3001, j)
        assert int(inter["totals"].sum()) == int(((j >= 0) & (j < 3001))
                                                 .sum())


@pytest.mark.parametrize("mode", ["store", "add", "max"])
def test_i64_indices_truncate(ctx1, tctx, mode, monkeypatch):
    """i64 indices above 2^31 are truncated to i32 first, as the
    reference's ``astype(int32)``."""
    hy, hp, hv = _inputs(3, np.float32, 4096, 4096, mode, idt=np.int64)
    shift = np.random.default_rng(4).integers(-3, 4, hp.size) << 32
    hp = hp + shift
    assert np.abs(hp).max() > 1 << 31

    def value(pkg, c):
        return pkg.vector(data=hv, context=c)
    want = _jax_run(ctx1, hy, hp, value, mode)
    got, _, _ = _port_run(tctx, hy, hp, value, mode)
    _check(got, want, np.float32, mode)
    idx, val, scalar = _operands(tctx, hy, hp, value, mode, monkeypatch)
    for rb, tile in PLANS:
        _check(_mirror(hy, idx, val, scalar, mode, rb, tile)[0], want,
               np.float32, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_scalar_and_expression_values(ctx1, tctx, dt, mode, monkeypatch):
    """A scalar value crosses as the kernel's scalar (no value array);
    an index and a value that are expressions are evaluated by one K1
    launch (its plain version here) into an i32 index and a value of the
    target's type."""
    hy, hp, hv = _inputs(5, dt, 4000, 2500, mode, spill=30)

    def scalar_value(pkg, c):
        return 3

    def expr_value(pkg, c):
        return pkg.vector(data=hv, context=c) * 2 + 1

    for value, index in ((scalar_value, None),
                         (expr_value, lambda p: p * 1)):
        jy = vex.vector(data=hy.copy(), context=ctx1)
        jp = vex.vector(data=hp, context=ctx1)
        jidx = jp if index is None else index(jp)
        if mode == "store":
            vex.permutation(jidx)(jy).assign(value(vex, ctx1))
        else:
            vex.eval(getattr(vex, f"atomic_{mode}")(
                vex.permutation(jidx)(jy), value(vex, ctx1)))
        want = np.asarray(jy.to_numpy())
        idx, val, scalar = _operands(tctx, hy, hp, value, mode, monkeypatch,
                                     index)
        if index is None:
            assert val is None and np.asarray(scalar).dtype == hy.dtype
            assert int(scalar) == 3 and idx.dtype == torch.int32
        else:
            assert scalar is None and idx.dtype == torch.int32
            assert val.dtype == torch.from_numpy(hy).dtype
        for rb, tile in PLANS:
            _check(_mirror(hy, idx, val, scalar, mode, rb, tile)[0], want,
                   dt, mode)


def test_atomic_sub_is_the_add_of_the_negation(ctx1, tctx, monkeypatch):
    """``atomic_sub`` reaches the kernels as an add of -v (a scalar -1
    stays a scalar)."""
    hy, hp, _ = _inputs(6, np.int32, 3000, 12000, "add")

    def value(pkg, c):
        return 1
    jy = vex.vector(data=hy.copy(), context=ctx1)
    vex.eval(vex.atomic_sub(vex.permutation(vex.vector(
        data=hp, context=ctx1))(jy), 1))
    want = np.asarray(jy.to_numpy())
    monkeypatch.setattr(cs, "PRIVATIZED_MIN_UPDATES", 0)
    ty = vt.vector(data=hy.copy(), context=tctx)
    args = prepare_view_assign(vt.permutation(vt.vector(
        data=hp, context=tctx))(ty), 1, atomic="sub")
    form, idx, val, scalar = _scatter_operands(*args)
    assert val is None and int(scalar) == -1 and args[6] == "add"
    assert form == "privatized"      # 3000 bins, 4 updates a bin
    out = torch.from_numpy(hy.copy())
    cs.scatter_privatized(out, idx, val, "add", scalar)
    np.testing.assert_array_equal(out.numpy(), want)
    out = torch.from_numpy(hy.copy())
    cs.ranges_mirror(out, idx, val, "add", scalar,
                     cs.range_plan(3000, 12000, 4, 256))
    np.testing.assert_array_equal(out.numpy(), want)


def test_mirror_pairs_are_a_stable_sort_by_range():
    """The mirror's pairs are the valid updates stably sorted by range:
    each range's first pair at the exclusive scan of the totals, the
    offsets range-major over the tiles, and within a range the updates
    in index order."""
    rng = np.random.default_rng(7)
    target, n, log_r, tile = 1000, 3000, 6, 128
    idx = torch.from_numpy(rng.integers(-50, target + 50, n)).to(torch.int32)
    val = torch.from_numpy(rng.standard_normal(n))
    out = torch.zeros(target, dtype=torch.float64)
    plan = cs.RangePlan(log_r, -(-target >> log_r), tile, -(-n // tile))
    inter = cs.ranges_mirror(out, idx, val, "add", None, plan)
    j = idx.long()
    j = torch.where(j < 0, j + target, j)
    valid = (j >= 0) & (j < target)
    order = torch.argsort(j[valid] >> log_r, stable=True)
    assert torch.equal(inter["ppos"], (j[valid] & 63)[order])
    assert torch.equal(inter["pval"], val[valid][order])
    assert torch.equal(inter["bases"], torch.cumsum(inter["totals"], 0)
                       - inter["totals"])
    flat = inter["counts"].t().reshape(-1)
    assert torch.equal(inter["offsets"].reshape(-1),
                       torch.cumsum(flat, 0) - flat)
    assert inter["counts"].shape == (plan.tiles, plan.ranges)


def test_histogram_through_both_packages(ctx1, tctx):
    """``atomic_add(permutation(keys)(hist), 1)`` of 2^14 keys: both
    packages give ``bincount``; the route sends it to form B at the
    chip's sizes (2^24 keys into 2^16 bins)."""
    keys = np.random.default_rng(9).integers(0, 1 << 10, 1 << 14).astype(
        np.int32)
    want = np.bincount(keys, minlength=1 << 10).astype(np.int32)
    jh = vex.vector(data=np.zeros(1 << 10, np.int32), context=ctx1)
    vex.eval(vex.atomic_add(vex.permutation(vex.vector(
        data=keys, context=ctx1))(jh), 1))
    th = vt.vector(data=np.zeros(1 << 10, np.int32), context=tctx)
    vt.eval(vt.atomic_add(vt.permutation(vt.vector(
        data=keys, context=tctx))(th), 1))
    np.testing.assert_array_equal(np.asarray(jh.to_numpy()), want)
    np.testing.assert_array_equal(th.to_numpy(), want)
    assert cs.route("add", torch.int32, 1 << 16, 1 << 24) == "privatized"


def test_route_is_a_pure_function_of_sizes_modes_and_types():
    """``route`` over sizes, modes and types: the thresholds decide, and
    what the kernels do not take stays on V3's Triton kernel."""
    big = 1 << 24
    f32, f64 = torch.float32, torch.float64
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64):
        for mode in ("store", "add", "min", "max"):
            assert cs.route(mode, dt, big, big) == "ranges"
            assert cs.route(mode, dt, big, big) == cs.route(mode, dt, big,
                                                            big)
        for mode in ("add", "min", "max"):
            assert cs.route(mode, dt, 1 << 12, 1 << 23) == "privatized"
            assert cs.route(mode, dt, 1 << 12, (1 << 23) - 1) is None
            assert cs.route(mode, dt, 1 << 18, 1 << 23) is None
        assert cs.route("store", dt, 1 << 12, 1 << 22) is None
    for dt in (torch.float16, torch.bfloat16, torch.uint8, torch.bool):
        assert cs.route("store", dt, big, big) is None
    assert cs.route("mul", f32, big, big) is None
    assert cs.route("store", f32, big, 0) is None
    assert cs.route("store", f32, 1 << 31, big) is None
    # form A: a target of at least RANGES_MIN_TARGET elements, at least a
    # quarter of an update an element and RANGES_MIN_UPDATES updates
    least = cs.RANGES_MIN_TARGET
    assert cs.route("store", f32, least, least) == "ranges"
    assert cs.route("store", f32, least - 1, least) is None
    assert cs.route("store", f64, least, least) == "ranges"
    assert cs.route("store", f64, least // 2, least // 2) is None
    assert cs.route("store", f32, big, big // 4) == "ranges"
    assert cs.route("store", f32, big, big // 4 - 1) is None
    assert cs.route("store", f32, least, cs.RANGES_MIN_UPDATES - 1) is None
    # more ranges than the distribute kernel holds, or a count matrix
    # beyond its bound
    huge = cs.MAX_RANGES * (cs.RANGE_BYTES // 4) + 1
    assert cs.route("store", f32, huge, huge) is None
    assert cs.route("store", f64, 1 << 25, 1 << 25) == "ranges"
    assert cs.route("store", f64, 1 << 26, 1 << 26) is None
    # form B: few enough windows and updates enough; float min and max
    # in one window only
    w32, _ = cs.window_plan(1, 4)
    w64, _ = cs.window_plan(1, 8)
    assert w32 == 2 * w64
    most = cs.PRIVATIZED_MAX_WINDOWS
    for dt, w in ((torch.int32, w32), (f32, w32), (f64, w64)):
        assert cs.route("add", dt, most * w, 1 << 24) == "privatized"
        assert cs.route("add", dt, most * w + 1, 1 << 24) is None
        assert cs.route("max", dt, w, 1 << 24) == "privatized"
        assert cs.route("max", dt, w + 1, 1 << 24) == (
            None if dt.is_floating_point else "privatized")
    assert cs.route("add", f32, 1 << 16, (1 << 23) - 1) is None


#: (mode, type, log2 target, updates an element) -> the form that was
#: fastest there, or None where V3's Triton kernel was (or none of the
#: forms was 10% faster), from the sweep's readings (PERF.md §6)
SWEEP_READINGS = [
    ("store", torch.float32, 23, 1, "ranges"),
    ("store", torch.float32, 23, 1 / 4, None),
    ("store", torch.float32, 24, 1 / 16, None),
    ("store", torch.float64, 22, 1, None),
    ("add", torch.float64, 22, 1, None),
    ("max", torch.int64, 24, 1 / 4, "ranges"),
    ("min", torch.float32, 26, 1, "ranges"),
    ("add", torch.float32, 17, 256, "privatized"),
    ("add", torch.float32, 18, 256, None),
    ("add", torch.int64, 16, 256, "privatized"),
    ("add", torch.int64, 17, 256, None),
    ("add", torch.int32, 16, 16, None),
    ("min", torch.float32, 16, 256, None),
    ("max", torch.float64, 15, 256, None),
    ("max", torch.int32, 17, 256, "privatized"),
    ("add", torch.int32, 14, 1 / 256, None),
]


@pytest.mark.parametrize("mode,dt,lg,per,form", SWEEP_READINGS)
def test_route_keeps_the_faster_form(mode, dt, lg, per, form):
    """``route`` sends each swept size to the form that beat V3's Triton
    kernel there, and leaves the rest to it."""
    assert cs.route(mode, dt, 1 << lg, int((1 << lg) * per)) == form


@pytest.mark.parametrize("target,n", [(1 << 14, 1 << 14), (12345, 777),
                                      (100, 1 << 14)])
def test_range_plan_covers_every_update(target, n):
    """The plan's ranges cover the target, its tiles the updates, in
    whole rounds of the distribute kernel, and the count matrix stays
    within its bound."""
    for size in (4, 8):
        p = cs.range_plan(target, n, size)
        assert p.ranges << p.log_r >= target > (p.ranges - 1) << p.log_r
        assert (1 << p.log_r) * size == cs.RANGE_BYTES
        assert p.tile % cs.CHUNK == 0 and p.tile * p.tiles >= n
        assert p.tile * (p.tiles - 1) < n
        assert p.ranges * p.tiles <= max(cs.MATRIX_WORDS, p.ranges)
        assert p.tile * (size + 2) <= max(cs.STAGE_BYTES, cs.CHUNK * 10)
