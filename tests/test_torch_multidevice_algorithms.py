"""Sort, FFT, the keyed scans, reduce_by_key and any_of/all_of over the
parts of a partitioned vector, against vexcl_tpu's 8-device mesh and
against the port's one part.

The JAX package distributes these over the suite's 8 virtual CPU devices
(the ``ctx`` fixture of tests/conftest.py: ``ops/sort_dist.py``,
``ops/fft_dist.py``, the shard_map pair scan of ``ops/scan_by_key.py``);
the port holds one tensor a part, in contexts of 3, 4 and 8 parts on the
CPU, with weighted (uneven) and empty parts too.  The same seeded numpy
inputs go through both, at sizes the JAX package distributes (n divisible
by 8; 64 | n for the FFT).  Tolerances, relative to the largest magnitude
of the reference:

* sort / sort_by_key with ties, NaN, ``descending``, ``key_fn``, tuple,
  unsigned and boolean keys: bit for bit (both are stable sorts); the merge-split schedule
  sorts every 0-1 input of up to 12 elements over any partition of up to
  5 parts (hypothesis draws the partitions; the 0-1 principle);
* the FFT, 1-D and 2-D, forward and inverse, ``dtype=`` passed: c64 1e-4,
  c128 1e-10; the route (four-step or gathered) is checked;
* keyed scans with ``init`` (add, max, min; one key and tuple keys; a
  custom ``op``; ``key_eq``) and ``reduce_by_key`` (a run spanning whole
  parts): f64 1e-12, exact on counts and keys; max and min, and every
  result against the port's one part with integer-valued data, bit for
  bit;
* ``any_of``/``all_of``: equal.
"""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu_torch.ops import fft_dist
from vexcl_tpu_torch.ops.sort_dist import merge_schedule, sort_parts
from vexcl_tpu_torch.parallel import partition as tpart

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


@pytest.fixture
def uneven():
    """A context of 6 parts weighted 3, 0, 1, 4, 0, 2 (two empty)."""
    tpart.reset_partitioning()
    weights = [3.0, 0.0, 1.0, 4.0, 0.0, 2.0]
    calls = itertools.count()
    vt.set_partitioning(lambda dev: weights[next(calls) % 6])
    try:
        yield _ctx(6)
    finally:
        tpart.reset_partitioning()


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    scale = max([1.0, *np.abs(want[fin]).ravel()])
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rtol * scale)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# -- sort ------------------------------------------------------------------

N = 1000


def _sort_case(name):
    """(keys, values, descending, key_fn for each package): ties, NaN and
    -0.0/+0.0 among f32 keys; i32 keys with an even-first transform; a
    tuple of keys."""
    rng = np.random.default_rng(41)
    f = rng.integers(0, 20, N).astype(np.float32)
    f[rng.random(N) < 0.05] = np.nan
    f[f == 0] = -0.0
    f[:3] = [0.0, -0.0, 0.0]
    i = rng.integers(-50, 50, N).astype(np.int32)
    v = np.arange(N, dtype=np.float64)
    if name == "nan_ties":
        return [f], [v], False, None
    if name == "descending":
        return [f], [v, i], True, None
    if name == "key_fn":
        return [i], [v], False, lambda k: (k & 1, k)
    if name == "tuple":
        return [(i % 7).astype(np.int16), f], [v], False, None
    if name == "unsigned_bool":      # through sort._sortable, as on one part
        u = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
        return [rng.random(N) < 0.5, u], [v], False, None
    return [f], [], False, None                  # a sort of keys alone


SORT_CASES = ["nan_ties", "descending", "key_fn", "tuple", "unsigned_bool",
              "keys_only"]


def _port_sort(ctx, case):
    ks, vs, desc, key_fn = _sort_case(case)
    tk = [vt.vector(data=k, context=ctx) for k in ks]
    tv = [vt.vector(data=v, context=ctx) for v in vs]
    if tv:
        vt.sort_by_key(tuple(tk), tuple(tv), descending=desc, key_fn=key_fn)
    else:
        vt.sort(tuple(tk), descending=desc, key_fn=key_fn)
    return [v.to_numpy() for v in tk + tv]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_matches_jax_and_one_part(ctx, tctx1, parts, case):
    def jax_sort():
        ks, vs, desc, key_fn = _sort_case(case)
        jk = [vex.vector(data=k, context=ctx) for k in ks]
        jv = [vex.vector(data=v, context=ctx) for v in vs]
        if jv:
            vex.sort_by_key(tuple(jk), tuple(jv), descending=desc,
                            key_fn=key_fn)
        else:
            vex.sort(tuple(jk), descending=desc, key_fn=key_fn)
        return [np.asarray(v) for v in jk + jv]

    want = _jax_once(("sort", case), jax_sort)
    one = _port_sort(tctx1, case)
    merges = sort_parts.merges
    got = _port_sort(_ctx(parts), case)
    assert sort_parts.merges - merges == parts * (parts - 1) // 2
    for g, o, w in zip(got, one, want):
        _bits(g, o)
        _bits(g, w)


@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_over_uneven_and_empty_parts(tctx1, uneven, case):
    for g, o in zip(_port_sort(uneven, case), _port_sort(tctx1, case)):
        _bits(g, o)


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(0, 5), min_size=1, max_size=5).filter(
    lambda s: 0 < sum(s) <= 12))
def test_merge_schedule_sorts_every_0_1_input(sizes):
    """Every 0-1 input over blocks of these sizes (the non-empty parts'
    blocks of ``sort_parts``, each sorted first) comes out sorted after
    the schedule's merges: all 2^n inputs at once, one row each."""
    n = sum(sizes)
    rows = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1).astype(np.int8)
    pts = np.concatenate([[0], np.cumsum(sizes)])
    blocks = [np.sort(rows[:, a:b], axis=1) for a, b in zip(pts[:-1], pts[1:])
              if b > a]
    fills = [b.shape[1] for b in blocks]
    for i, keep in merge_schedule(fills):
        both = np.sort(np.concatenate([blocks[i], blocks[i + 1]], axis=1),
                       axis=1)
        blocks[i], blocks[i + 1] = both[:, :keep], both[:, keep:]
    assert [b.shape[1] for b in blocks] == fills
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  np.sort(rows, axis=1))


@settings(max_examples=15, deadline=None, database=None)
@given(st.lists(st.integers(0, 4), min_size=2, max_size=5).filter(
    lambda w: sum(w) > 0), st.integers(1, 12), st.integers(0, 2 ** 31))
def test_sort_over_random_partitions(weights, n, seed):
    """sort_by_key over a random weighting (empty parts among them) equals
    the one-part sort of random 0-1 keys."""
    keys = np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int64)
    tpart.reset_partitioning()
    calls = itertools.count()
    vt.set_partitioning(lambda dev: weights[next(calls) % len(weights)])
    try:
        ctx = _ctx(len(weights))
        k, v = (vt.vector(data=keys, context=ctx),
                vt.vector(data=vals, context=ctx))
        vt.sort_by_key(k, v)
    finally:
        tpart.reset_partitioning()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k.to_numpy(), keys[order])
    np.testing.assert_array_equal(v.to_numpy(), vals[order])


# -- FFT -------------------------------------------------------------------

#: 72^2 = 2^6 3^4 points: a four-step split over 3, 4 and 8 parts; the 2-D
#: shape's extents divide by 3, 4 and 8
FFT_1D, FFT_2D = (5184,), (48, 96)
FFT_TOL = {np.complex64: 1e-4, np.complex128: 1e-10}


def _signal(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("shape,inverse,dt", [
    (FFT_1D, False, np.complex64), (FFT_1D, True, np.complex128),
    (FFT_2D, True, np.complex64), (FFT_2D, False, np.complex128)])
def test_fft_matches_jax_four_step(ctx, tctx1, monkeypatch, parts, shape,
                                   inverse, dt):
    n = int(np.prod(shape))
    x = _signal(n).astype(dt)

    def jax_fft():
        f = vex.FFT(shape, inverse=inverse, dtype=dt)
        xv = vex.vector(data=x, context=ctx)
        assert f(xv).plan.impl == "dist"
        y = vex.vector(n, dtype=dt, context=ctx)
        y[:] = f(xv)
        return np.asarray(y)

    want = _jax_once(("fft", shape, inverse, dt), jax_fft)
    steps = []
    monkeypatch.setattr(fft_dist, "gathered", lambda *a: steps.append(a))
    real = fft_dist.four_step
    monkeypatch.setattr(fft_dist, "four_step",
                        lambda *a: steps.append("4") or real(*a))
    tc = _ctx(parts)
    f = vt.FFT(shape, inverse=inverse, dtype=dt)
    xv = vt.vector(data=x, context=tc)
    assert f(xv).plan.impl == "dist"
    y = vt.vector(n, dtype=dt, context=tc)
    y[:] = f(xv)                                  # into the target's parts
    z = vt.vector(n, dtype=dt, context=tc)
    z[:] = 2 * f(xv * 0.5)                        # in a tree, of a tree
    assert steps == ["4", "4"] and y.nparts == parts
    _close(y.to_numpy(), want, FFT_TOL[dt])
    _close(z.to_numpy(), want, FFT_TOL[dt])
    x1 = vt.vector(data=x, context=tctx1)
    y1 = vt.vector(n, dtype=dt, context=tctx1)
    y1[:] = f(x1)
    _close(y.to_numpy(), y1.to_numpy(), FFT_TOL[dt])


def test_fft_in_place_and_explicit_dist(tctx1):
    x = _signal(1024).astype(np.complex128)
    want = np.fft.fft(x)
    tc = _ctx(4)
    v = vt.vector(data=x, context=tc)
    v[:] = vt.fft(v, dtype=np.complex128)
    _close(v.to_numpy(), want, 1e-10)
    fd = vt.FFT(1024, impl="dist", dtype=np.complex128)
    y = vt.vector(1024, dtype=np.complex128, context=tc)
    y[:] = fd(vt.vector(data=x, context=tc))
    _close(y.to_numpy(), want, 1e-10)
    with pytest.raises(ValueError, match="dist"):      # one part
        vt.vector(1024, dtype=np.complex128, context=tctx1).assign(
            fd(vt.vector(data=x, context=tctx1)))
    with pytest.raises(ValueError, match="decompose"):
        y3 = vt.vector(1024, dtype=np.complex128, context=_ctx(3))
        y3[:] = fd(vt.vector(data=x, context=_ctx(3)))
    with pytest.raises(ValueError, match="1-D and full 2-D"):
        vt.FFT((4, 4, 4), impl="dist")


@pytest.mark.parametrize("shape,parts", [((1000,), 4), ((5184,), 5),
                                         ((12, 20), 8), ((16, 32), 6)])
def test_fft_that_does_not_decompose_is_gathered(tctx1, monkeypatch, shape,
                                                 parts):
    """n not divisible by D^2, a 2-D extent D does not divide, uneven
    parts: the parts gathered to the first part's device, transformed by
    the one-part plan and written back."""
    n = int(np.prod(shape))
    x = _signal(n)
    steps = []
    real = fft_dist.gathered
    monkeypatch.setattr(fft_dist, "gathered",
                        lambda *a: steps.append("g") or real(*a))
    monkeypatch.setattr(fft_dist, "four_step", lambda *a: steps.append(a))
    for inverse in (False, True):
        f = vt.FFT(shape, inverse=inverse, dtype=np.complex128)
        xv = vt.vector(data=x, context=_ctx(parts))
        assert f(xv).plan.impl == "xla"
        y = vt.vector(n, dtype=np.complex128, context=_ctx(parts))
        y[:] = f(xv)
        fn = np.fft.ifftn if inverse else np.fft.fftn
        _close(y.to_numpy(), fn(x.reshape(shape)).reshape(-1), 1e-10)
    assert steps == ["g", "g"]


def test_fft_over_uneven_parts_is_gathered(uneven):
    x = _signal(5184)
    f = vt.FFT(5184, dtype=np.complex128)
    xv = vt.vector(data=x, context=uneven)
    assert f(xv).plan.impl == "xla"
    y = vt.vector(5184, dtype=np.complex128, context=uneven)
    y[:] = f(xv)
    _close(y.to_numpy(), np.fft.fft(x), 1e-10)


# -- keyed scans -----------------------------------------------------------

def _keyed_inputs(n=N, seed=43):
    """Sorted i32 keys in runs of 1-12 with one run of 300 (longer than a
    part of 8 or 4 parts), a second i64 key, f64 values."""
    rng = np.random.default_rng(seed)
    k = np.repeat(np.arange(n), rng.integers(1, 13, n))[:n].astype(np.int32)
    k[400:700] = k[400]
    k2 = (rng.random(n) < 0.9).astype(np.int64)
    return k, k2, rng.standard_normal(n), rng.integers(-9, 10, n).astype(
        np.float64)


def _scan(pkg, ctx, keys, x, exclusive, **kw):
    fn = pkg.exclusive_scan_by_key if exclusive else pkg.inclusive_scan_by_key
    kv = tuple(pkg.vector(data=k, context=ctx) for k in keys)
    out = fn(kv if len(kv) > 1 else kv[0], pkg.vector(data=x, context=ctx),
             **kw)
    return out.to_numpy() if pkg is vt else np.asarray(out)


SCAN_CASES = [("add", False, None, 2), ("add", True, 1.5, 1),
              ("max", False, 1.5, 1), ("max", True, None, 2),
              ("min", False, None, 1), ("min", True, 1.5, 2)]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("mono,exclusive,init,nkeys", SCAN_CASES)
def test_scan_by_key_matches_jax(ctx, tctx1, parts, mono, exclusive, init,
                                 nkeys):
    k, k2, x, xi = _keyed_inputs()
    keys = [k, k2][:nkeys]
    name = None if mono == "add" else mono
    want = _jax_once(("sbk", mono, exclusive, init, nkeys), lambda: _scan(
        vex, ctx, keys, x, exclusive, init=init, op_name=name))
    tc = _ctx(parts)
    got = _scan(vt, tc, keys, x, exclusive, init=init, op_name=name)
    _close(got, want, 1e-12)
    _bits(got if mono != "add" else _scan(vt, tc, keys, xi, exclusive,
                                          init=init, op_name=name),
          _scan(vt, tctx1, keys, x if mono != "add" else xi, exclusive,
                init=init, op_name=name))


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_by_key_custom_op_and_key_eq_match_jax(ctx, tctx1, parts,
                                                    exclusive):
    """The plain route over parts: a custom op (the pair monoid scanned
    with ``associative_scan``) and a key predicate (keys equal up to their
    tens)."""
    k, k2, x, xi = _keyed_inputs()
    op = lambda a, b: a * 0 + b + a  # noqa: E731
    key_eq = lambda a, b: (a // 10) == (b // 10)  # noqa: E731
    tc = _ctx(parts)
    for what, keys, kw in (("op", [k, k2], dict(op=op, init=3.0)),
                           ("key_eq", [k], dict(key_eq=key_eq, init=1.0))):
        want = _jax_once(("sbk", what, exclusive), lambda: _scan(
            vex, ctx, keys, xi, exclusive, **kw))
        got = _scan(vt, tc, keys, xi, exclusive, **kw)
        _bits(got, want)
        _bits(got, _scan(vt, tctx1, keys, xi, exclusive, **kw))


@pytest.mark.parametrize("mono", ["add", "max", "min"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_by_key_over_uneven_and_empty_parts(tctx1, uneven, mono,
                                                 exclusive):
    k, k2, _, xi = _keyed_inputs()
    name = None if mono == "add" else mono
    for keys, init in (([k], None), ([k, k2], 2.0)):
        _bits(_scan(vt, uneven, keys, xi, exclusive, init=init, op_name=name),
              _scan(vt, tctx1, keys, xi, exclusive, init=init, op_name=name))
    for n in (1, 2, 7):             # parts of one element, and none
        a = np.arange(n, dtype=np.float64)
        kk = np.zeros(n, np.int32)
        _bits(_scan(vt, uneven, [kk], a, exclusive, op_name=name),
              _scan(vt, tctx1, [kk], a, exclusive, op_name=name))


def test_scan_by_key_in_place_over_parts(tctx1):
    k, _, _, xi = _keyed_inputs()
    tc = _ctx(4)
    x = vt.vector(data=xi, context=tc)
    vt.inclusive_scan_by_key(vt.vector(data=k, context=tc), x, x)
    _bits(x.to_numpy(), _scan(vt, tctx1, [k], xi, False))


# -- reduce_by_key ---------------------------------------------------------

def _rbk(pkg, ctx, keys, x, **kw):
    kv = tuple(pkg.vector(data=k, context=ctx) for k in keys)
    ok, ov, m = pkg.reduce_by_key(kv if len(kv) > 1 else kv[0],
                                  pkg.vector(data=x, context=ctx), **kw)
    ok = ok if len(kv) > 1 else (ok,)
    get = (lambda v: v.to_numpy()) if pkg is vt else np.asarray
    return [get(v) for v in ok], get(ov), m


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("case", ["add", "max", "key_eq", "op"])
def test_reduce_by_key_matches_jax(ctx, tctx1, parts, case):
    """One run of 300 spans whole parts of 8 and 4 parts; tuple keys."""
    k, k2, x, xi = _keyed_inputs()
    keys = [k, k2] if case in ("add", "op") else [k]
    kw = {"add": {}, "max": dict(op_name="max"),
          "key_eq": dict(key_eq=lambda a, b: (a // 10) == (b // 10)),
          "op": dict(op=lambda a, b: a * 0 + b + a)}[case]
    wk, wv, wm = _jax_once(("rbk", case), lambda: _rbk(vex, ctx, keys, x,
                                                         **kw))
    tc = _ctx(parts)
    gk, gv, gm = _rbk(vt, tc, keys, x, **kw)
    assert gm == wm
    for g, w in zip(gk, wk):
        _bits(g, w)
    _close(gv, wv, 1e-12)
    ok, ov, om = _rbk(vt, tctx1, keys, xi, **kw)
    gk, gv, gm = _rbk(vt, tc, keys, xi, **kw)
    assert gm == om
    for g, o in zip([*gk, gv], [*ok, ov]):
        _bits(g, o)


def test_reduce_by_key_over_uneven_and_empty_parts(tctx1, uneven):
    k, k2, _, xi = _keyed_inputs()
    for keys, kw in (([k], {}), ([k, k2], dict(op_name="min"))):
        gk, gv, gm = _rbk(vt, uneven, keys, xi, **kw)
        ok, ov, om = _rbk(vt, tctx1, keys, xi, **kw)
        assert gm == om
        for g, o in zip([*gk, gv], [*ok, ov]):
            _bits(g, o)
    for n in (0, 1, 2, 7):          # parts of one element, and none
        kk, a = np.zeros(n, np.int32), np.arange(n, dtype=np.float64)
        (gk,), gv, gm = _rbk(vt, uneven, [kk], a)
        assert gm == min(n, 1) and gv.tolist() == ([a.sum()] if n else [])


def test_reduce_by_key_over_parts_fills_containers():
    """Passed containers of the context are resized and filled in their
    types, partitioned by the context's points for the count; the result
    parts sit on the parts' devices."""
    k, _, _, xi = _keyed_inputs()
    tc = _ctx(4)
    ok = vt.vector(3, dtype=np.int64, context=tc)
    ov = vt.vector(3, dtype=np.float32, context=tc)
    gk, gv, m = vt.reduce_by_key(vt.vector(data=k, context=tc),
                                 vt.vector(data=xi, context=tc),
                                 okeys=ok, ovals=ov)
    heads = np.r_[True, k[1:] != k[:-1]]
    assert gk is ok and gv is ov and m == heads.sum()
    assert ov.size == m and ov.dtype == torch.float32 and ov.nparts == 4
    np.testing.assert_array_equal(ov.partition(), vt.partition(m, tc))
    np.testing.assert_array_equal(ok.to_numpy(), k[heads])
    np.testing.assert_array_equal(
        ov.to_numpy(), np.add.reduceat(xi, np.flatnonzero(heads)))
    with pytest.raises(ValueError, match="context"):
        vt.reduce_by_key(vt.vector(data=k, context=tc),
                         vt.vector(data=xi, context=tc),
                         ovals=vt.vector(3, context=_ctx(3)))


# -- any_of / all_of -------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS)
def test_any_all_of_match_jax(ctx, parts):
    tc = _ctx(parts)
    for case in ("zeros", "one", "ones", "nan", "but_last"):
        a = {"zeros": np.zeros(N), "ones": np.ones(N), "nan": np.zeros(N),
             "one": np.zeros(N), "but_last": np.ones(N)}[case]
        a[-1] = {"zeros": 0, "ones": 1, "nan": np.nan, "one": 1,
                 "but_last": 0}[case]
        want = _jax_once(("any_all", case), lambda: (
            vex.any_of(vex.vector(data=a, context=ctx)),
            vex.all_of(vex.vector(data=a, context=ctx) + 1 - 1)))
        v = vt.vector(data=a, context=tc)
        assert (vt.any_of(v), vt.all_of(v + 1 - 1)) == want
