"""The gather through a permutation in the port (``ops/cuda_gather.py``)
against vexcl_tpu, on the CPU.

The same numpy inputs (from a seed) go through the JAX package's
``permutation(p)(x)`` (``jnp.take`` of the i32 index), through the port's
API (on the CPU the plain version of the assignment kernel), through the
operands the route hands the CUDA form (``triton_emit._gather_operands``,
its thresholds lowered) into ``gather_plain`` and ``gather_ranges`` (its
plain version on the CPU), and through the CPU mirror of the form's plan
(``ranges_mirror``: the tiles' counting sort by source range, the gather
in that order, the restore) at small ranges and tiles, so that a case
spans many of each, ragged last ones included.  ``route`` is checked as a
pure function of sizes and types.  Everything is compared bitwise: a
gather moves bits (the fill of an index out of range is NaN or the least
integer, NaN compared as NaN).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.node import ArrayTerminal
from vexcl_tpu_torch.expr.view import PermutationView
from vexcl_tpu_torch.expr.triton_emit import _gather_operands
from vexcl_tpu_torch.ops import cuda_gather as cg

TYPES = [np.float32, np.float64, np.int32, np.int64]

#: small cuts: (range bytes, tile)
CUTS = [(64, 8), (512, 40), (1 << 12, 1024), (1 << 17, 1 << 15)]


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


@pytest.fixture()
def routed(monkeypatch):
    """The route's thresholds lowered so that it takes these sizes."""
    monkeypatch.setattr(cg, "MIN_SOURCE_BYTES", 0)
    monkeypatch.setattr(cg, "MIN_PER_ELEMENT", {4: 0, 8: 0})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.itemsize == 4 else np.uint64) \
        if np.issubdtype(a.dtype, np.floating) else a


def _check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))
    else:
        np.testing.assert_array_equal(got, want)


def _inputs(seed, dt, src_len, n, spill=0, idt=np.int32):
    """(source, index): a permutation's prefix where n is at most the
    source, uniform indices otherwise; ``spill`` of them negative (each
    wraps once) or out of range."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dt, np.floating):
        hx = (rng.standard_normal(src_len) * 10).astype(dt)
    else:
        hx = rng.integers(-1000, 1000, src_len).astype(dt)
    hp = rng.permutation(src_len)[:n] if n <= src_len else \
        rng.integers(0, src_len, n)
    if spill:
        at = rng.choice(n, spill, replace=False)
        hp[at] = rng.choice([-1, -src_len, src_len, src_len + 5,
                             -src_len - 1, 3 * src_len], spill)
    return hx, hp.astype(idt)


def _jax_take(ctx1, hx, hp):
    jx = vex.vector(data=hx, context=ctx1)
    jp = vex.vector(data=hp, context=ctx1)
    jy = vex.vector(len(hp), dtype=hx.dtype, context=ctx1)
    jy[:] = vex.permutation(jp)(jx)
    return np.asarray(jy.to_numpy())


def _port(tctx, hx, hp):
    """(API result, the route's operands, the vectors)."""
    tx = vt.vector(data=hx, context=tctx)
    tp = vt.vector(data=hp, context=tctx)
    ty = vt.vector(len(hp), dtype=hx.dtype, context=tctx)
    ty[:] = vt.permutation(tp)(tx)
    e, an, ty_, lv = prepare(vt.permutation(tp)(tx), len(hp), tctx.device)
    out = torch.empty(len(hp), dtype=tx.storage.dtype)
    ops = _gather_operands(e, an, ty_, lv, out)
    return ty.to_numpy().copy(), ops, (tx, tp, ty)


def _through_form(ops, n, dtype):
    """gather_plain and gather_ranges of the operands, and the mirror at
    each of CUTS: each result."""
    idx, src = ops
    outs = []
    for fn in (cg.gather_plain, cg.gather_ranges):
        o = torch.empty(n, dtype=dtype)
        fn(o, idx, src)
        outs.append(o.numpy())
    for rb, tile in CUTS:
        o = torch.empty(n, dtype=dtype)
        cg.ranges_mirror(o, idx, src, cg.gather_plan(
            src.numel(), n, src.element_size(), rb, tile))
        outs.append(o.numpy())
    return outs


@pytest.mark.parametrize("idt", [np.int32, np.int64])
@pytest.mark.parametrize("case", [(5000, 3777), (1 << 12, 1 << 12),
                                  (1000, 1 << 14)])
@pytest.mark.parametrize("dt", TYPES)
def test_types_and_sizes(ctx1, tctx, routed, dt, case, idt):
    """Every routed type and index type, n below, at and above the source
    length, some indices negative or out of range: vexcl_tpu, the port's
    API, the route's operands through the plain version and the wrapper,
    and the mirror at four cuts give ``jnp.take``'s answer bitwise."""
    src_len, n = case
    hx, hp = _inputs(1, dt, src_len, n, spill=n // 10, idt=idt)
    want = _jax_take(ctx1, hx, hp)
    got, ops, _ = _port(tctx, hx, hp)
    _check(got, want)
    assert ops is not None and ops[0].dtype == torch.from_numpy(hp).dtype
    assert ops[1].dtype == torch.from_numpy(hx).dtype
    for o in _through_form(ops, n, ops[1].dtype):
        _check(o, want)


def test_i64_indices_truncate(ctx1, tctx, routed):
    """i64 indices of 2^31 and more are truncated to i32 first, as the
    reference's ``astype(int32)``; then wrapped or read as the fill."""
    hx, hp = _inputs(2, np.float32, 4096, 4096, idt=np.int64)
    hp = hp + (np.random.default_rng(3).integers(-3, 4, hp.size) << 32)
    assert np.abs(hp).max() > 1 << 31
    want = _jax_take(ctx1, hx, hp)
    got, ops, _ = _port(tctx, hx, hp)
    _check(got, want)
    for o in _through_form(ops, hp.size, torch.float32):
        _check(o, want)


@pytest.mark.parametrize("shared", ["index", "source"])
def test_index_or_source_shares_the_output(ctx1, tctx, routed, shared):
    """``p[:] = permutation(p)(s)`` and ``x[:] = permutation(p)(x)``: the
    form reads its index and source before it writes, so each gives
    ``jnp.take`` of the old values; the route takes both."""
    hx, hp = _inputs(4, np.int32, 3000, 3000, spill=30)
    if shared == "index":
        want = _jax_take(ctx1, hx, hp)
        tp = vt.vector(data=hp, context=tctx)
        tx = vt.vector(data=hx, context=tctx)
        args = prepare(vt.permutation(tp)(tx), 3000, tctx.device)
        ops = _gather_operands(*args, tp.storage)
        assert ops is not None and ops[0] is tp.storage
        cg.gather_ranges(tp.storage, *ops)
        _check(tp.to_numpy(), want)
        tp = vt.vector(data=hp, context=tctx)
        tp[:] = vt.permutation(tp)(tx)
        _check(tp.to_numpy(), want)
    else:
        want = _jax_take(ctx1, hx, hp)
        tx = vt.vector(data=hx, context=tctx)
        tp = vt.vector(data=hp, context=tctx)
        args = prepare(vt.permutation(tp)(tx), 3000, tctx.device)
        ops = _gather_operands(*args, tx.storage)
        assert ops is not None and ops[1] is tx.storage
        for rb, tile in CUTS:
            o = tx.storage.clone()
            cg.ranges_mirror(o, ops[0], o, cg.gather_plan(3000, 3000, 4, rb,
                                                          tile))
            _check(o.numpy(), want)
        tx[:] = vt.permutation(tp)(tx)
        _check(tx.to_numpy(), want)


def test_what_the_route_leaves(tctx, routed):
    """No operands (V1's single pass) for a tree around the view, an
    expression index, a cast, a source of another type or a slice, and
    for types the form does not take."""
    hx, hp = _inputs(5, np.float32, 2048, 2048)
    tx = vt.vector(data=hx, context=tctx)
    tp = vt.vector(data=hp, context=tctx)
    x16 = vt.vector(data=hx.astype(np.float16), context=tctx)
    for expr, dt in ((vt.permutation(tp)(tx) + 1, torch.float32),
                     (vt.permutation(tp * 1)(tx), torch.float32),
                     (vt.permutation(tp)(tx), torch.float64),
                     (vt.permutation(tp)(tx * 2), torch.float32),
                     (vt.permutation(tp[0:1024])(tx), torch.float32),
                     (vt.permutation(tp)(x16), torch.float16)):
        n = expr.size_hint()
        e, an, ty, lv = prepare(expr, n, tctx.device)
        out = torch.empty(n, dtype=dt)
        assert _gather_operands(e, an, ty, lv, out) is None


@pytest.mark.parametrize("cut", CUTS)
def test_mirror_plan_covers_every_destination_once(cut):
    """Each destination lies in exactly one (tile, bucket) run, the runs
    of a tile in bucket order with the out-of-range bucket last, its
    entries in destination order within a run; each entry's index within
    its range; the offsets of a tile are a permutation of the tile (the
    restore inverts the partition)."""
    rng = np.random.default_rng(6)
    src_len, n = 3001, 5003
    idx = torch.from_numpy(rng.integers(-50, src_len + 50, n))
    src = torch.from_numpy(rng.standard_normal(src_len))
    plan = cg.gather_plan(src_len, n, 8, *cut)
    out = torch.empty(n, dtype=torch.float64)
    m = cg.ranges_mirror(out, idx, src, plan)
    starts, soff, sidx = m["starts"], m["soff"], m["sidx"]
    assert starts.shape == (plan.ranges + 2, plan.tiles)
    lens = torch.diff(starts, dim=0)
    assert torch.equal(lens.sum(0), torch.tensor(
        [min(plan.tile, n - t * plan.tile) for t in range(plan.tiles)]))
    tile_of = torch.arange(n) // plan.tile
    dest = tile_of * plan.tile + soff
    assert torch.equal(torch.sort(dest).values, torch.arange(n))
    bucket = torch.repeat_interleave(
        torch.arange(plan.ranges + 1).repeat(plan.tiles), lens.t().reshape(-1))
    j = idx.to(torch.int32).long()
    j = torch.where(j < 0, j + src_len, j)
    valid = (j >= 0) & (j < src_len)
    want_bucket = torch.where(valid, j >> plan.log_s, plan.ranges)
    assert torch.equal(bucket, want_bucket[dest])
    local = torch.where(valid, j & ((1 << plan.log_s) - 1), 0)
    assert torch.equal(sidx, local[dest])
    run = tile_of * (plan.ranges + 1) + bucket
    same_run = run[1:] == run[:-1]
    assert bool((soff[1:][same_run] > soff[:-1][same_run]).all())
    np.testing.assert_array_equal(out.numpy()[dest.numpy()],
                                  m["sval"].numpy())


def test_route_is_a_pure_function_of_sizes_and_types():
    """``route`` over sizes and types: the thresholds decide, and what
    the form does not take stays on V1."""
    big = 1 << 24
    i32, i64 = torch.int32, torch.int64
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64):
        for idt in (i32, i64):
            assert cg.route(dt, big, big, idt)
            assert cg.route(dt, big, big, idt) == cg.route(dt, big, big, idt)
            assert not cg.route(dt, 1 << 12, 1 << 12, idt)
    for dt in (torch.float16, torch.bfloat16, torch.uint8, torch.bool,
               torch.int16):
        assert not cg.route(dt, big, big, i32)
    assert not cg.route(torch.float32, big, big, torch.int16)
    assert not cg.route(torch.float32, big, 0, i32)
    assert not cg.route(torch.float32, 0, big, i32)
    assert not cg.route(torch.float32, 1 << 31, big, i32)
    assert not cg.route(torch.float32, big, 1 << 31, i32)
    # the thresholds: source bytes, and destinations an element by width
    least = cg.MIN_SOURCE_BYTES
    for dt in (torch.float32, torch.float64, torch.int32, torch.int64):
        size = dt.itemsize
        n_least = int(cg.MIN_PER_ELEMENT[size] * (least // size))
        assert cg.route(dt, least // size, n_least, i32)
        assert not cg.route(dt, least // size - 1, n_least, i32)
        assert not cg.route(dt, least // size, n_least - 1, i64)
        assert cg.route(dt, 4 * least // size, 4 * n_least, i64)
    assert cg.MIN_PER_ELEMENT[4] < cg.MIN_PER_ELEMENT[8]
    # more ranges than the partition counts
    huge = cg.MAX_RANGES * cg.RANGE_ELEMENTS
    assert cg.route(torch.float32, huge, huge, i32)
    assert not cg.route(torch.float32, huge + 1, huge + 1, i32)


#: (type, log2 source bytes, destinations an element, routed) and the
#: V1/form ratio of events ms through random i32 indices the sweep read
#: there (PERF.md §6)
SWEEP_READINGS = [
    (torch.float32, 26, 1, True),        # 1.55
    (torch.float32, 26, 1 / 4, True),    # 1.23
    (torch.float32, 25, 1, False),       # 0.90
    (torch.float32, 25, 4, False),       # 0.95
    (torch.float32, 24, 1, False),       # 0.69
    (torch.float32, 28, 1 / 16, False),  # 0.91
    (torch.int32, 27, 1 / 4, True),      # 1.49
    (torch.int32, 22, 16, False),        # 0.46
    (torch.float64, 26, 1, True),        # 1.12
    (torch.float64, 26, 1 / 4, False),   # 0.74
    (torch.float64, 27, 1 / 4, False),   # 0.94
    (torch.float64, 28, 1, True),        # 1.34
    (torch.int64, 26, 4, True),          # 1.23
    (torch.int64, 25, 4, False),         # 0.82
]


@pytest.mark.parametrize("dt,lg,per,form", SWEEP_READINGS)
def test_route_keeps_the_faster_form(dt, lg, per, form):
    """``route`` sends each swept size where the form beat V1's single
    pass through random indices, and leaves the rest to V1."""
    src_len = (1 << lg) // dt.itemsize
    assert cg.route(dt, src_len, int(src_len * per), torch.int32) == form


def test_vex_gather_and_scatter(ctx1, tctx, routed):
    """``vex.gather`` (i64 host indices, a permutation through
    ``evaluate``) gives vexcl_tpu's answer, and the route takes its
    operands; ``vex.scatter`` of the gathered values puts them back."""
    hx, hp = _inputs(7, np.float64, 1 << 14, 1 << 13)
    jx = vex.vector(data=hx, context=ctx1)
    tx = vt.vector(data=hx, context=tctx)
    want = np.asarray(vex.gather(jx, hp))
    got = vt.gather(tx, hp)
    _check(got, want)
    _check(got, hx[hp])
    node = PermutationView(ArrayTerminal(torch.from_numpy(hp.astype(
        np.int64))), tx._as_terminal())
    e, an, ty, lv = prepare(node, hp.size, tctx.device)
    ops = _gather_operands(e, an, ty, lv,
                           torch.empty(hp.size, dtype=torch.float64))
    assert ops is not None and ops[0].dtype == torch.int64
    ty = vt.vector(1 << 14, dtype=np.float64, context=tctx)
    vt.scatter(got, hp, ty)
    np.testing.assert_array_equal(ty.to_numpy()[hp], hx[hp])
