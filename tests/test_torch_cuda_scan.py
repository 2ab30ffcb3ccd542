"""The scan family on the card: ``scan`` and ``segscan`` (every monoid and
type, tile and window edges, NaN, unaligned views, many calls, two
streams, bounded scratch, one launch), the single-pass compaction, and
the keyed kernel (``reduce_by_key`` and the keyed scans) against their
plain versions and the route it replaced.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_scan.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from _cuda_common import gpu, _vec, _close, _kernels_launched, _bits

pytestmark = pytest.mark.cuda


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
