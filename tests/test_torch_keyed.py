"""Parity of the port's keyed algorithms with vexcl_tpu.

The plain segmented scan and the plain compaction (the CPU forms of
ops/cuda_scan.py and ops/cuda_compact.py) are held against the JAX
package's Pallas kernels in interpret mode (``pallas_segmented_cumsum_flags``
and ``pallas_compact``, whose block-local layout is mapped to global
positions); ``inclusive_scan_by_key``/``exclusive_scan_by_key`` against
its public API (tuple keys, ``key_eq``, ``init``, max/min, a custom op);
and ``reduce_by_key`` against its fused path (``_reduce_by_key_fused``)
and its compact path (``_reduce_by_key_compact``), both in interpret
mode, on the key patterns of tests/test_algorithms.py, and against its
public API for max/min, ``key_eq`` (each run reports its first key),
passed containers, tuples of keys of mixed widths, f32/f64 keys with
-0.0/+0.0 and NaN (each run reports its tail's key) and f64, i64 and
bf16 values.  On the CPU the port's keyed calls with a standard monoid
run the plain versions of ops/cuda_by_key.py.

Tolerances: keys, counts, MAX/MIN and integer results exactly; f32 sums
2e-5 relative (reduce_by_key, as tests/test_algorithms.py) or 1e-5
relative to the largest magnitude (scans), f64 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.ops.pallas_compact import BLOCK_R, LANE, pallas_compact
from vexcl_tpu.ops.pallas_segscan import pallas_segmented_cumsum_flags
from vexcl_tpu.ops.reduce_by_key import (_reduce_by_key_compact,
                                         _reduce_by_key_fused)
from vexcl_tpu_torch.ops.cuda_compact import compact_plain
from vexcl_tpu_torch.ops.cuda_scan import segscan_plain

N = 300_000
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _np(a):
    if isinstance(a, vt.vector):
        a = a.storage
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _close(got, want, rtol, exact=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    scale = max(1.0, np.abs(want.astype(np.float64)).max(initial=0.0))
    err = np.abs(got.astype(np.float64) - want).max(initial=0.0)
    assert err <= rtol * scale, (err, scale)


def _heads(rng, n, p=0.02):
    f = (rng.random(n) < p).astype(np.int8)
    f[0] = 1
    return f


@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_segscan_plain_matches_pallas(mono):
    rng = np.random.default_rng(71)
    f = _heads(rng, N + 1)
    x = rng.standard_normal(N + 1).astype(np.float32)
    want = np.asarray(pallas_segmented_cumsum_flags(jnp.asarray(f),
                                                    jnp.asarray(x), mono))
    got = segscan_plain(torch.from_numpy(f), torch.from_numpy(x), mono)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5, exact=mono != "add")


@pytest.mark.parametrize("p", [0.0, 0.03, 1.0])
def test_compact_plain_matches_pallas(p):
    """Results, not layouts: the JAX kernel's block-local slots are mapped
    to global positions and its blocks concatenated in order."""
    rng = np.random.default_rng(72)
    n = N + 7
    f = (rng.random(n) < p).astype(np.int8)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64)
    c = rng.integers(-9, 9, n).astype(np.int32)
    pos, counts, *comp = pallas_compact(jnp.asarray(f), jnp.asarray(a),
                                        jnp.asarray(b), jnp.asarray(c))
    block = BLOCK_R * LANE
    pos, counts = np.asarray(pos), np.asarray(counts).astype(np.int64)
    keep = np.arange(pos.shape[1])[None, :] < counts[:, None]
    gpos = (pos + np.arange(pos.shape[0])[:, None] * block)[keep]
    count, *outs = compact_plain(
        torch.from_numpy(f), torch.arange(n), torch.from_numpy(a),
        torch.from_numpy(b), torch.from_numpy(c))
    m = int(count)
    assert m == counts.sum() == f.sum()
    np.testing.assert_array_equal(outs[0][:m].numpy(), gpos.astype(np.int64))
    for got, want in zip(outs[1:], comp):
        np.testing.assert_array_equal(got[:m].numpy(), np.asarray(want)[keep])
        assert got.shape == (n,)


def test_compact_apply_views_and_widths_match_pallas():
    """The compaction entry point on the CPU: a flags view at a 1-byte
    offset (as the kernel reads one on the card), bool and u8 flags, and
    payloads of every width the kernel moves; the 32- and 64-bit payloads
    against the JAX kernel's result, the 8- and 16-bit ones (which it does
    not take) against numpy's selection."""
    from vexcl_tpu_torch.ops.cuda_compact import compact_apply

    rng = np.random.default_rng(73)
    n = 5000 + 3
    buf = (rng.random(n + 1) < 0.3).astype(np.uint8)
    f = buf[1:]
    wide = [rng.standard_normal(n).astype(np.float32),
            rng.integers(-2 ** 40, 2 ** 40, n).astype(np.int64),
            rng.standard_normal(n)]
    narrow = [rng.integers(0, 256, n).astype(np.uint8),
              rng.integers(-999, 999, n).astype(np.int16),
              rng.random(n) < 0.5]
    pos, counts, *comp = pallas_compact(jnp.asarray(f.astype(np.int8)),
                                        *[jnp.asarray(a) for a in wide])
    counts = np.asarray(counts).astype(np.int64)
    keep = np.arange(np.asarray(pos).shape[1])[None, :] < counts[:, None]
    tflags = torch.from_numpy(buf)[1:]
    assert tflags.storage_offset() == 1
    for flags in (tflags, tflags.bool()):
        count, *outs = compact_apply(
            flags, *[torch.from_numpy(a) for a in wide + narrow])
        m = int(count)
        assert m == counts.sum() == f.sum()
        for got, want in zip(outs, comp):
            np.testing.assert_array_equal(got[:m].numpy(),
                                          np.asarray(want)[keep])
        for got, a in zip(outs[len(wide):], narrow):
            assert got.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(got[:m].numpy(), a[f != 0])


def _keys(rng, n):
    k1 = np.sort(rng.integers(0, n // 40, n)).astype(np.int32)
    k2 = (rng.random(n) < 0.5).astype(np.int64)
    return k1, k2


def _key_set(name, rng, n):
    """The key vectors of a case: one i32 vector, an (i32, i64) tuple, a
    tuple of 1-, 2-, 4- and 8-byte keys (bool among them), or f32 and f64
    keys with runs of mixed -0.0/+0.0 (one [-0.0, +0.0] run at 10) and NaN
    keys (each a run of its own)."""
    k1, k2 = _keys(rng, n)
    if name == "one":
        return [k1]
    if name == "tuple":
        return [k1, k2]
    if name == "mixed_widths":
        return [(k1 // 3).astype(np.int16), k2.astype(bool),
                (k1 % 5).astype(np.int8), k1.astype(np.int64)]
    f = (k1 // 50).astype(np.float32) - 1
    f[f == 0] *= np.where(rng.random(int((f == 0).sum())) < 0.5, -1, 1)
    f[[8, 9, 10, 11, 12]] = [5.0, 6.0, -0.0, 0.0, 7.0]
    f[rng.random(n) < 0.01] = np.nan
    g = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    return [f, g]


@pytest.mark.parametrize("init", [None, 2.5])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", ["add", "max", "min"])
@pytest.mark.parametrize("keys", ["one", "tuple", "mixed_widths",
                                  "signed_zero"])
def test_scan_by_key_matches_jax(ctx1, tctx, keys, mono, exclusive, init):
    rng = np.random.default_rng(73)
    n = 20011
    hk = _key_set(keys, rng, n)
    x = rng.standard_normal(n)
    jk = [vex.vector(data=k, context=ctx1) for k in hk]
    tk = [vt.vector(data=k, context=tctx) for k in hk]
    jx = vex.vector(data=x, context=ctx1)
    tx = vt.vector(data=x, context=tctx)
    name = None if mono == "add" else mono
    jfn = vex.exclusive_scan_by_key if exclusive else vex.inclusive_scan_by_key
    tfn = vt.exclusive_scan_by_key if exclusive else vt.inclusive_scan_by_key
    want = jfn(tuple(jk) if keys != "one" else jk[0], jx, init=init,
               op_name=name)
    got = tfn(tuple(tk) if keys != "one" else tk[0], tx, init=init,
              op_name=name)
    assert got.dtype == torch.float64
    _close(got, want, TOL[np.float64], exact=mono != "add")


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dt", [np.float32, np.int32])
def test_scan_by_key_key_eq_and_custom_op(ctx1, tctx, dt, exclusive):
    """A key predicate (keys equal up to their tens) and a custom op run
    the generic pair scan on both sides."""
    rng = np.random.default_rng(74)
    n = 9001
    k = np.sort(rng.integers(0, 2000, n)).astype(np.int32)
    x = rng.integers(-5, 6, n).astype(dt)
    jk, tk = vex.vector(data=k, context=ctx1), vt.vector(data=k, context=tctx)
    jx, tx = vex.vector(data=x, context=ctx1), vt.vector(data=x, context=tctx)
    key_eq = lambda a, b: (a // 10) == (b // 10)  # noqa: E731
    jfn = vex.exclusive_scan_by_key if exclusive else vex.inclusive_scan_by_key
    tfn = vt.exclusive_scan_by_key if exclusive else vt.inclusive_scan_by_key
    _close(tfn(tk, tx, key_eq=key_eq, init=1),
           jfn(jk, jx, key_eq=key_eq, init=1), 0, exact=True)
    op = lambda a, b: a * 0 + b + a  # noqa: E731
    _close(tfn(tk, tx, op=op, init=3), jfn(jk, jx, op=op, init=3), 0,
           exact=True)


def test_scan_by_key_float_keys_split_at_nan(ctx1, tctx):
    k = np.array([1.0, 1.0, np.nan, np.nan, 2.0, 2.0], np.float32)
    x = np.arange(6, dtype=np.float32)
    want = vex.inclusive_scan_by_key(vex.vector(data=k, context=ctx1),
                                     vex.vector(data=x, context=ctx1))
    got = vt.inclusive_scan_by_key(vt.vector(data=k, context=tctx),
                                   vt.vector(data=x, context=tctx))
    _close(got, want, 0, exact=True)
    np.testing.assert_array_equal(_np(got), [0, 1, 2, 3, 4, 9])


def _patterns(rng, n):
    return {
        "runs64": (np.arange(n) // 64).astype(np.int32),
        "single": np.zeros(n, np.int32),
        "distinct": np.arange(n, dtype=np.int32),
        "random": np.sort(rng.integers(0, n // 50, n)).astype(np.int32),
        "unsorted_runs": rng.integers(0, 9, n).astype(np.int32),
    }


@pytest.mark.parametrize("path", ["fused", "compact"])
@pytest.mark.parametrize("pattern", ["runs64", "single", "distinct",
                                     "random", "unsorted_runs"])
def test_reduce_by_key_matches_jax_kernel_paths(ctx1, tctx, path, pattern):
    rng = np.random.default_rng(75)
    hv = rng.random(N).astype(np.float32)
    hk = _patterns(rng, N)[pattern]
    jfn = _reduce_by_key_fused if path == "fused" else _reduce_by_key_compact
    jv = vex.vector(data=hv, context=ctx1, sharded=False)
    wk, wv, wm = jfn([jnp.asarray(hk)], jv, None, None, False)
    tk, tv, tm = vt.reduce_by_key(vt.vector(data=hk, context=tctx),
                                  vt.vector(data=hv, context=tctx))
    assert tm == wm and tk.size == tv.size == tm
    assert tv.dtype == torch.float32 and tk.dtype == torch.int32
    _close(tk, wk, 0, exact=True)
    np.testing.assert_allclose(_np(tv), np.asarray(wv), rtol=2e-5)


@pytest.mark.parametrize("mono", ["max", "min"])
@pytest.mark.parametrize("pattern", ["runs64", "random", "unsorted_runs"])
def test_reduce_by_key_max_min_match_jax_fused(ctx1, tctx, mono, pattern):
    rng = np.random.default_rng(76)
    hv = rng.standard_normal(N).astype(np.float32)
    hk = _patterns(rng, N)[pattern]
    jv = vex.vector(data=hv, context=ctx1, sharded=False)
    wk, wv, wm = _reduce_by_key_fused([jnp.asarray(hk)], jv, None, None,
                                      False, mono)
    tk, tv, tm = vt.reduce_by_key(vt.vector(data=hk, context=tctx),
                                  vt.vector(data=hv, context=tctx),
                                  op_name=mono)
    assert tm == wm
    _close(tk, wk, 0, exact=True)
    _close(tv, wv, 0, exact=True)


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.int32, np.int64,
                                "bfloat16"])
@pytest.mark.parametrize("keys", ["tuple", "mixed_widths", "signed_zero"])
def test_reduce_by_key_tuple_keys_and_containers(ctx1, tctx, keys, dt):
    """Tuples of keys of one or mixed widths, float keys with -0.0/+0.0 and
    NaN, values of every type the kernel takes, into passed containers:
    each run's key is its tail's, bit for bit.  bf16 sums: the JAX path
    adds in bf16, the port in f32 (2e-2 of the largest magnitude)."""
    import ml_dtypes

    rng = np.random.default_rng(77)
    n = 30001
    hk = _key_set(keys, rng, n)
    x = rng.integers(-50, 50, n).astype(
        ml_dtypes.bfloat16 if dt == "bfloat16" else dt)
    jk = tuple(vex.vector(data=k, context=ctx1) for k in hk)
    tk = tuple(vt.vector(data=k, context=tctx) for k in hk)
    wk, wv, wm = vex.reduce_by_key(jk, vex.vector(data=x, context=ctx1))
    ok = tuple(vt.vector(5, dtype=k.dtype, context=tctx) for k in hk)
    ov = vt.vector(5, dtype=x.dtype, context=tctx)
    gk, gv, gm = vt.reduce_by_key(tk, vt.vector(data=x, context=tctx),
                                  okeys=ok, ovals=ov)
    assert gm == wm and gv is ov and all(a is b for a, b in zip(gk, ok))
    assert ov.size == gm and ov.dtype == vt.dtype_of(x.dtype)
    for g, w in zip(gk, wk):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    if dt == "bfloat16":
        _close(gv.to_numpy().astype(np.float32),
               np.asarray(wv).astype(np.float32), 2e-2)
    else:
        _close(gv, wv, 0, exact=True)         # integer-valued sums


def test_reduce_by_key_key_eq_reports_first_key(ctx1, tctx):
    rng = np.random.default_rng(78)
    n = 10007
    k = np.sort(rng.integers(0, 3000, n)).astype(np.int32)
    x = rng.random(n)
    key_eq = lambda a, b: (a // 10) == (b // 10)  # noqa: E731
    wk, wv, wm = vex.reduce_by_key(vex.vector(data=k, context=ctx1),
                                   vex.vector(data=x, context=ctx1),
                                   key_eq=key_eq)
    gk, gv, gm = vt.reduce_by_key(vt.vector(data=k, context=tctx),
                                  vt.vector(data=x, context=tctx),
                                  key_eq=key_eq)
    assert gm == wm
    _close(gk, wk, 0, exact=True)
    heads = np.r_[True, k[1:] // 10 != k[:-1] // 10]
    np.testing.assert_array_equal(_np(gk), k[heads])
    _close(gv, wv, TOL[np.float64])


def test_reduce_by_key_custom_op_and_bf16(ctx1, tctx):
    rng = np.random.default_rng(79)
    k = np.sort(rng.integers(0, 500, 8000)).astype(np.int32)
    x = rng.random(8000)
    op = lambda a, b: a * b  # noqa: E731
    wk, wv, wm = vex.reduce_by_key(vex.vector(data=k, context=ctx1),
                                   vex.vector(data=x, context=ctx1), op=op)
    gk, gv, gm = vt.reduce_by_key(vt.vector(data=k, context=tctx),
                                  vt.vector(data=x, context=tctx), op=op)
    assert gm == wm
    _close(gk, wk, 0, exact=True)
    np.testing.assert_allclose(_np(gv), np.asarray(wv), rtol=1e-12)
    # bf16 values: the port carries sums in f32, the JAX XLA path in bf16
    import ml_dtypes

    xb = rng.random(8000).astype(ml_dtypes.bfloat16)
    wk, wv, wm = vex.reduce_by_key(vex.vector(data=k, context=ctx1),
                                   vex.vector(data=xb, context=ctx1))
    gk, gv, gm = vt.reduce_by_key(vt.vector(data=k, context=tctx),
                                  vt.vector(data=xb, context=tctx))
    assert gm == wm and gv.dtype == torch.bfloat16
    np.testing.assert_allclose(gv.to_numpy(), np.asarray(wv, np.float32),
                               rtol=2e-2)
