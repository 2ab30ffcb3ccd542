"""The keyed kernel's decomposition on the CPU: ``by_key_tiled`` (the
tile, window and (head, value, tails) look-back of ``csrc/by_key.cuh`` in
plain PyTorch) at tiny tiles and windows against the plain versions the
API runs, ``reduce_by_key_plain`` and ``scan_by_key_plain``, and against
``scan_tiled`` (``csrc/scan.cu``'s decomposition) on the same head flags;
and the kernel's comparison of keys by their bits against
``k[:-1] == k[1:]``.

Tolerances: integer results and integer-valued float data exactly; float
sums of random data bit for bit against ``scan_tiled`` (the same
bracketing) and within 1e-5 (f32) or 1e-12 (f64) of the largest magnitude
against the plain versions (another bracketing); MAX and MIN exactly.
"""

import numpy as np
import pytest
import torch

from vexcl_tpu_torch.ops.cuda_by_key import (_kernel_neq, by_key_tiled,
                                             reduce_by_key_plain,
                                             reduce_by_key_apply,
                                             scan_by_key_apply,
                                             scan_by_key_plain,
                                             segment_heads)
from vexcl_tpu_torch.ops.cuda_scan import scan_tiled

TILE, WINDOW = 8, 4                    # the decomposition, small
N = 3 * WINDOW * TILE + 5              # three windows and a ragged tail
MODES = [(False, None), (True, None), (False, 2), (True, 3)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _keys(kind, n, rng):
    """Key vectors whose runs put heads where ``kind`` says (a shift of
    the tiles, as the kernel's alignment shift, moves them off the
    edges)."""
    pos = np.arange(n)
    if kind == "runs":
        k = np.sort(rng.integers(0, n // 3, n))
    elif kind in ("tile_starts", "tile_ends", "window_starts"):
        period = TILE * WINDOW if kind == "window_starts" else TILE
        start = pos % period == (period - 1 if kind == "tile_ends" else 0)
        k = np.cumsum(start)
    elif kind == "one_run":            # one run over every window
        k = np.zeros(n, np.int64)
    else:                              # "distinct": every element a run
        k = pos
    # a second key vector of another width: a head of its own mid-way
    second = (pos >= n // 2) & (kind == "runs")
    return (torch.from_numpy(k.astype(np.int32)),
            torch.from_numpy(second.astype(np.int8)))


def _values(dt, n, rng, integral):
    if not dt.is_floating_point or integral:
        return torch.from_numpy(rng.integers(-9, 10, n)).to(dt)
    return torch.from_numpy(rng.standard_normal(n)).to(dt)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    an, bn = torch.isnan(a), torch.isnan(b)
    assert torch.equal(an, bn) and torch.equal(a[~an], b[~bn])


def _close(a, b, dt):
    assert a.dtype == b.dtype and a.shape == b.shape
    scale = max(1.0, b.double().abs().max().item())
    err = (a.double() - b.double()).abs().max().item()
    assert err <= TOL[dt] * scale, (err, scale)


@pytest.mark.parametrize("mono", ["add", "max", "min"])
@pytest.mark.parametrize("kind", ["runs", "tile_starts", "tile_ends",
                                  "window_starts", "one_run", "distinct"])
def test_by_key_tiled_matches_plain(kind, mono):
    """Heads on every tile and window edge, one run over several windows,
    every element its own run: the scan in every mode and reduce_by_key
    (count, slots, totals, tail keys) exactly for integers and
    integer-valued floats, with and without an alignment shift."""
    rng = np.random.default_rng(90)
    keys = _keys(kind, N, rng)
    for dt in (torch.int32, torch.float32, torch.float64):
        x = _values(dt, N, rng, integral=True)
        m, vals, tail_keys = reduce_by_key_plain(keys, x, mono)
        for shift in (0, 3):
            for exclusive, init in MODES:
                y, count, tot, tk = by_key_tiled(keys, x, mono, TILE, WINDOW,
                                                 shift, exclusive, init)
                _same(y, scan_by_key_plain(keys, x, mono, exclusive, init))
                assert count == m
                _same(tot, vals)
                for a, b in zip(tk, tail_keys):
                    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["runs", "tile_ends", "window_starts",
                                  "one_run"])
def test_by_key_tiled_float_sums_bitwise_with_scan_tiled(kind, dt):
    """Random float sums: the keyed decomposition gives scan_tiled's bits
    on the same heads (the kernels' shared bracketing), the totals are
    those bits at the tails, and both lie within the tolerance of the
    plain versions."""
    rng = np.random.default_rng(91)
    keys = _keys(kind, N, rng)
    x = _values(dt, N, rng, integral=False)
    heads = segment_heads(keys)
    tails = torch.cat([heads[1:], heads.new_ones(1)])
    for shift in (0, 3):
        y, count, tot, _ = by_key_tiled(keys, x, "add", TILE, WINDOW, shift)
        incl = scan_tiled(x, "add", heads, TILE, WINDOW, shift)
        assert torch.equal(y, incl)
        assert count == int(tails.sum()) and torch.equal(tot, incl[tails])
        _close(y, scan_by_key_plain(keys, x, "add"), dt)
        _close(tot, reduce_by_key_plain(keys, x, "add")[1], dt)
        ye, *_ = by_key_tiled(keys, x, "add", TILE, WINDOW, shift,
                              exclusive=True, init=1.5)
        want = torch.where(heads, torch.tensor(1.5, dtype=dt),
                           1.5 + torch.cat([incl.new_zeros(1), incl[:-1]]))
        assert torch.equal(ye, want)


def test_by_key_tiled_one_element():
    for dt in (torch.int64, torch.float32, torch.bfloat16):
        x = torch.tensor([5], dtype=dt)
        k = torch.tensor([7], dtype=torch.int16)
        for exclusive, init in MODES:
            y, count, tot, tk = by_key_tiled((k,), x, "max", TILE, WINDOW, 3,
                                             exclusive, init)
            _same(y, scan_by_key_plain((k,), x, "max", exclusive, init))
            assert count == 1 and torch.equal(tot, x) and torch.equal(tk[0], k)


def _key_data(dt, n, rng):
    """Keys in runs, with NaN, -0.0/+0.0, infinities for float types."""
    base = np.sort(rng.integers(-3, 4, n)).astype(np.float64)
    if dt.is_floating_point or dt.is_complex:
        sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        base = np.where(base == 0, sign * 0.0, base)
        special = rng.random(n)
        base[special < 0.05] = np.nan
        base[(special > 0.05) & (special < 0.08)] = np.inf
        t = torch.from_numpy(base)
        if dt.is_complex:
            imag = torch.from_numpy(np.where(rng.random(n) < 0.5, -0.0, 0.0))
            return torch.complex(t, imag).to(dt)
        return t.to(dt)
    if dt == torch.bool:
        return torch.from_numpy(base > 0)
    return torch.from_numpy(base).to(dt)


@pytest.mark.parametrize("dt", [torch.int8, torch.uint8, torch.int16,
                                torch.int32, torch.int64, torch.bool,
                                torch.float16, torch.bfloat16, torch.float32,
                                torch.float64, torch.complex32,
                                torch.complex64])
def test_kernel_key_comparison_matches_tensor_equality(dt):
    """The kernel's comparison of key bits (integers as bits, float lanes
    as values: NaN differs from everything, -0.0 equals +0.0) gives the
    head flags of ``k[:-1] == k[1:]``."""
    rng = np.random.default_rng(92)
    k = _key_data(dt, 4000, rng)
    want = ~(k[:-1] == k[1:])
    assert torch.equal(_kernel_neq(k), want)
    assert torch.equal(segment_heads((k,))[1:], want)


def test_signed_zero_run_reports_the_tail_key():
    """A run of [-0.0, +0.0] is one run; its key is the tail's (+0.0)."""
    k = torch.tensor([1.0, -0.0, 0.0, float("nan"), float("nan"), 2.0])
    x = torch.arange(6, dtype=torch.float32)
    m, vals, (keys,) = reduce_by_key_apply((k,), x, "add")
    assert m == 5
    assert torch.equal(vals, torch.tensor([0.0, 3.0, 3.0, 4.0, 5.0]))
    assert not torch.signbit(keys[1]).item()
    _, count, tot, (tk,) = by_key_tiled((k,), x, "add", 2, 2)
    assert count == m and torch.equal(tot, vals)
    assert torch.equal(tk.view(torch.int32), keys.view(torch.int32))


def test_wrappers_check_their_operands():
    x = torch.ones(10)
    k = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_by_key_apply([k] * 8, x)
    with pytest.raises(ValueError):
        reduce_by_key_apply((k[:9],), x)
    with pytest.raises(ValueError):
        scan_by_key_apply((k,), x, "prod")
    out = torch.empty(10)
    assert scan_by_key_apply((k,), x, out=out) is out
    assert torch.equal(out, torch.arange(1.0, 11.0))
