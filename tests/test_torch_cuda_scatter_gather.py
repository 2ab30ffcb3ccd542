"""The scatter through a permutation (``csrc/scatter.cu``: form A by
ranges, form B privatized) and the gather (``csrc/gather.cu``) against
their plain versions, ``index_select`` and the CPU mirrors of their
plans, and the routes' launches through the API, on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_scatter_gather.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.triton_emit import assign, assign_multi
from _cuda_common import gpu, cpu, _close, _kernels_launched, _bitwise, _same

pytestmark = pytest.mark.cuda


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
