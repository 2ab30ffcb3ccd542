"""Parity of the port's scans with vexcl_tpu.

The plain scan (the CPU form of ops/cuda_scan.py) is held against the JAX
package's Pallas scan kernels in interpret mode (``pallas_cumsum`` at a
length that is no block multiple, ``pallas_cummax``/``pallas_cummin`` as
tests/test_algorithms.py runs them) and against its XLA scan for the
types those kernels do not take; ``inclusive_scan``/``exclusive_scan``
against the JAX package's public API for each standard monoid, a custom
operator, ``init``, in place and NaN.  ``scan_tiled``, the CUDA kernel's
tile and window decomposition at a small tile and window, is held against
the plain scans and the JAX package's Pallas scans (f64: its XLA scan, as
its Pallas kernels compute in f32) over three windows and a ragged tail,
with heads on and off tile and window edges.

Tolerances, relative to the largest magnitude of the result: f32 sums
1e-5 (another summation order), f64 1e-12, bf16 1e-2 (the JAX package's
XLA path rounds every step to bf16, the port carries f32); MAX, MIN and
integer results bitwise.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.ops.pallas_monoid_scan import pallas_cummax, pallas_cummin
from vexcl_tpu.ops.pallas_scan import pallas_cumsum
from vexcl_tpu.ops.pallas_segscan import pallas_segmented_cumsum_flags
from vexcl_tpu_torch.ops.cuda_scan import (associative_scan, scan_plain,
                                           scan_tiled, segscan_plain)
from vexcl_tpu_torch.vector import host_tensor

TOL = {"f32": 1e-5, "f64": 1e-12, "bf16": 1e-2}
NP = {"f32": np.float32, "f64": np.float64, "i32": np.int32,
      "bf16": ml_dtypes.bfloat16}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _data(rng, n, dt, lo=-2.0, hi=2.0):
    if dt == "i32":
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return (lo + (hi - lo) * rng.random(n)).astype(NP[dt])


def _np(a):
    """A port vector or tensor, or a JAX vector or array, as f64 numpy."""
    if isinstance(a, vt.vector):
        a = a.storage
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def _check(got, want, dt, exact):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact or dt == "i32":
        np.testing.assert_array_equal(got, want)
        return
    scale = max(1.0, np.nanmax(np.abs(want), initial=0.0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.abs(got[fin] - want[fin]).max(initial=0.0) <= TOL[dt] * scale


@pytest.mark.parametrize("dt", ["f32", "f64", "bf16"])
def test_scan_plain_add_matches_pallas_cumsum(dt):
    n = 300001                               # not a multiple of the block
    h = _data(np.random.default_rng(61), n, dt, 0.0, 1.0)
    want = pallas_cumsum(jnp.asarray(h))
    got = scan_plain(host_tensor(h), "add")
    assert got.dtype == host_tensor(h).dtype
    _check(got, want, dt, exact=False)


@pytest.mark.parametrize("n", [1 << 18, 300001])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_plain_max_min_match_pallas(mono, n):
    h = np.random.default_rng(62).standard_normal(n).astype(np.float32)
    kern = pallas_cummax if mono == "max" else pallas_cummin
    want = np.asarray(kern(jnp.asarray(h)))
    got = scan_plain(torch.from_numpy(h), mono).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", ["f64", "i32"])
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_scan_plain_matches_xla_scan(mono, dt):
    """Types the Pallas kernels do not take: the JAX package's own scan."""
    h = _data(np.random.default_rng(63), 70001, dt)
    fn = {"add": jnp.add, "max": jnp.maximum, "min": jnp.minimum}[mono]
    want = jax.lax.associative_scan(fn, jnp.asarray(h))
    got = scan_plain(torch.from_numpy(h), mono)
    assert got.dtype == torch.from_numpy(h).dtype
    _check(got, want, dt, exact=mono != "add")


def test_scan_plain_integer_sums_wrap():
    h = np.full(10, 2 ** 30, np.int32)
    got = scan_plain(torch.from_numpy(h), "add").numpy()
    want = np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(h)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[3] == 0


def _pair(ctx1, tctx, h):
    return vex.vector(data=h, context=ctx1), vt.vector(data=h, context=tctx)


@pytest.mark.parametrize("init", [None, 3])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", ["add", "max", "min"])
@pytest.mark.parametrize("dt", ["f32", "f64", "i32", "bf16"])
def test_scan_api_matches_jax(ctx1, tctx, dt, mono, exclusive, init):
    """Each standard monoid by name; the exclusive scan shifts in a
    literal 0 (not the identity) and folds init as the JAX package does.
    bf16 sums take non-negative data: with cancellation the JAX package's
    bf16-rounded XLA scan is itself off by more than 1e-2."""
    lo = 0.0 if dt == "bf16" and mono == "add" else -2.0
    h = _data(np.random.default_rng(64), 5003, dt, lo)
    jx, tx = _pair(ctx1, tctx, h)
    name = None if mono == "add" else mono
    jfn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    tfn = vt.exclusive_scan if exclusive else vt.inclusive_scan
    want = jfn(jx, init=init, op_name=name)
    got = tfn(tx, init=init, op_name=name)
    assert got.dtype == tx.dtype and got.size == tx.size
    _check(got, want, dt, exact=mono != "add")


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_standard_callables(ctx1, tctx, mono, exclusive):
    h = _data(np.random.default_rng(65), 4097, "f32")
    jx, tx = _pair(ctx1, tctx, h)
    jfn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    tfn = vt.exclusive_scan if exclusive else vt.inclusive_scan
    want = jfn(jx, init=-0.5, op=getattr(jnp, mono + "imum"))
    got = tfn(tx, init=-0.5, op=getattr(torch, mono + "imum"))
    _check(got, want, "f32", exact=True)


@pytest.mark.parametrize("init", [None, 1.25])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("which", ["sum", "product", "last"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_scan_custom_operator(ctx1, tctx, dt, which, exclusive, init):
    """A custom callable runs the plain log-depth scan on both sides."""
    op = {"sum": lambda a, b: a + b, "product": lambda a, b: a * b,
          "last": lambda a, b: b + a * 0}[which]
    h = _data(np.random.default_rng(66), 3001, dt, 0.999, 1.001)
    jx, tx = _pair(ctx1, tctx, h)
    jfn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    tfn = vt.exclusive_scan if exclusive else vt.inclusive_scan
    _check(tfn(tx, init=init, op=op), jfn(jx, init=init, op=op), dt,
           exact=which == "last")


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", ["add", "max"])
def test_scan_in_place(ctx1, tctx, mono, exclusive):
    h = _data(np.random.default_rng(67), 9000, "f32")
    jx, tx = _pair(ctx1, tctx, h)
    name = None if mono == "add" else mono
    jfn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    tfn = vt.exclusive_scan if exclusive else vt.inclusive_scan
    jfn(jx, jx, op_name=name)
    assert tfn(tx, tx, op_name=name) is tx
    _check(tx, jx, "f32", exact=mono != "add")


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_max_min_propagate_nan(ctx1, tctx, mono, exclusive):
    h = _data(np.random.default_rng(68), 6000, "f32")
    h[4321] = np.nan
    jx, tx = _pair(ctx1, tctx, h)
    jfn = vex.exclusive_scan if exclusive else vex.inclusive_scan
    tfn = vt.exclusive_scan if exclusive else vt.inclusive_scan
    want = _np(jfn(jx, op_name=mono))
    got = _np(tfn(tx, op_name=mono))
    assert np.isnan(got[4322:]).all() and not np.isnan(got[:4321]).any()
    np.testing.assert_array_equal(got, want)


def test_scan_dst_of_another_type_and_short_inputs(ctx1, tctx):
    h = _data(np.random.default_rng(69), 1000, "f32", 0.0, 1.0)
    jx, tx = _pair(ctx1, tctx, h)
    jd = vex.vector(1000, dtype=np.float64, context=ctx1)
    td = vt.vector(1000, dtype=np.float64, context=tctx)
    vex.inclusive_scan(jx, jd)
    vt.inclusive_scan(tx, td)
    assert td.dtype == torch.float64
    _check(td, jd, "f32", exact=False)
    for n in (1, 2):
        jx, tx = _pair(ctx1, tctx, h[:n])
        for ex in (False, True):
            jfn = vex.exclusive_scan if ex else vex.inclusive_scan
            tfn = vt.exclusive_scan if ex else vt.inclusive_scan
            _check(tfn(tx, init=2.0), jfn(jx, init=2.0), "f32", exact=True)


def test_scan_names_without_a_callable_must_be_standard(ctx1, tctx):
    h = np.ones(10, np.float32)
    jx, tx = _pair(ctx1, tctx, h)
    with pytest.raises(ValueError):
        vex.inclusive_scan(jx, op_name="prod")
    with pytest.raises(ValueError, match="names no standard"):
        vt.inclusive_scan(tx, op_name="prod")
    # a custom op merely named "max" is not the standard maximum
    op = lambda a, b: a + b  # noqa: E731
    _check(vt.inclusive_scan(tx, op=op, op_name="max"),
           vex.inclusive_scan(jx, op=op, op_name="max"), "f32", exact=True)


def test_associative_scan_on_pairs_matches_jax():
    rng = np.random.default_rng(70)
    f = rng.random(3000) < 0.1
    v = rng.random(3000)

    def combine(a, b, where):
        (fa, va), (fb, vb) = a, b
        return fa | fb, where(fb, vb, va + vb)

    want = jax.lax.associative_scan(lambda a, b: combine(a, b, jnp.where),
                                    (jnp.asarray(f), jnp.asarray(v)))
    got = associative_scan(lambda a, b: combine(a, b, torch.where),
                           (torch.from_numpy(f), torch.from_numpy(v)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _check(got[1], want[1], "f64", exact=False)


TILE, WINDOW = 8, 4                    # scan_tiled's decomposition, small
N_TILED = 3 * WINDOW * TILE + 5        # three windows and a ragged tail
_JNP_OPS = {"add": jnp.add, "max": jnp.maximum, "min": jnp.minimum}


def _heads(kind, n, rng):
    pos = np.arange(n)
    return {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "tile_starts": pos % TILE == 0,
            "tile_ends": pos % TILE == TILE - 1,
            "window_starts": pos % (TILE * WINDOW) == 0,
            "one_in_window_1": pos == TILE * WINDOW + 13,
            "random": rng.random(n) < 0.1}[kind].astype(np.int8)


def _jax_scan(h, f, mono, dt, segmented):
    """The JAX package's scan of h: its Pallas kernels (f32, i32), its XLA
    scan of the (flag, value) pairs (f64)."""
    if dt == "f64":
        op = _JNP_OPS[mono]
        return jax.lax.associative_scan(
            lambda a, b: (a[0] | b[0], jnp.where(b[0], b[1], op(a[1], b[1]))),
            (jnp.asarray(f != 0), jnp.asarray(h)))[1]
    if segmented:
        return pallas_segmented_cumsum_flags(jnp.asarray(f), jnp.asarray(h),
                                             mono)
    return {"add": pallas_cumsum, "max": pallas_cummax,
            "min": pallas_cummin}[mono](jnp.asarray(h))


@pytest.mark.parametrize("kind", ["none", "all", "tile_starts", "tile_ends",
                                  "window_starts", "one_in_window_1",
                                  "random"])
@pytest.mark.parametrize("dt", ["f32", "i32", "f64"])
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_scan_tiled_order_matches_plain_and_jax(mono, dt, kind):
    """The kernel's combination order: tile aggregates, the fold of the
    window's aggregates onto the inclusive prefix of the window before, a
    head among them that makes that prefix irrelevant.  With no alignment
    shift the heads sit on tile and window edges; a shift of 3 moves every
    edge off them.  Tolerances as at the top; f64 1e-12."""
    rng = np.random.default_rng(80)
    h = _data(rng, N_TILED, dt)
    f = _heads(kind, N_TILED, rng)
    seg = kind != "none"
    xt, ft = torch.from_numpy(h), torch.from_numpy(f)
    plain = segscan_plain(ft, xt, mono) if seg else scan_plain(xt, mono)
    want = _jax_scan(h, f, mono, dt, seg)
    for shift in (0, 3):
        got = scan_tiled(xt, mono, ft if seg else None, TILE, WINDOW, shift)
        assert got.dtype == xt.dtype
        _check(got, plain, dt, exact=mono != "add")
        _check(got, want, dt, exact=mono != "add")


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("mono", ["max", "min"])
def test_scan_tiled_nan_in_an_earlier_window(mono, dt, segmented):
    """A NaN in window 0 reaches every later window through the chain of
    window prefixes (segmented: up to the next head, in window 2)."""
    rng = np.random.default_rng(81)
    h = _data(rng, N_TILED, dt)
    h[10] = np.nan
    f = np.zeros(N_TILED, np.int8)
    stop = 2 * TILE * WINDOW + 5
    if segmented:
        f[[0, stop]] = 1
    xt, ft = torch.from_numpy(h), torch.from_numpy(f)
    plain = segscan_plain(ft, xt, mono) if segmented else scan_plain(xt, mono)
    want = _jax_scan(h, f, mono, dt, segmented)
    for shift in (0, 3):
        got = scan_tiled(xt, mono, ft if segmented else None, TILE, WINDOW,
                         shift).numpy()
        end = stop if segmented else N_TILED
        assert np.isnan(got[10:end]).all() and not np.isnan(got[:10]).any()
        assert not np.isnan(got[end:]).any()
        _check(got, plain, dt, exact=True)
        _check(got, want, dt, exact=True)
