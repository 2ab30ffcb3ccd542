"""The port's three repaired faults and its host path, on the CPU.

Faults (each against vexcl_tpu on the same numpy inputs):

1. a 0-d tensor leaf is a scalar of its own, strong, type (as a 0-d jnp
   array is): ``x + t``, ``x += t``, ``x[:] = t``, ``sin(2.0) + x`` and
   its SUM;
2. u16/u32/u64 and boolean arithmetic on the CPU (a signed carrier,
   wrapped back): ``u + u``, MIN/MAX of unsigned vectors, boolean
   ``abs``, ``//``, ``%``, ``<<``, ``>>`` with the JAX package's types;
3. complex SUM and boolean MIN/MAX in the plain map-reduce.

The host path: a recorded kernel keeps its analysis per binding (no walk
of the trees on a repeated binding; two bindings alternately give the
JAX package's results); V2's kept schedule equals the one computed
afresh; ``Ap[:] = A * p`` writes into its target and ``x[:] = A * x``
keeps its temporary; a 0-d tensor leaf's kernel source and key; the
launch records' argument classes.  Integer and boolean results are
exact; f32 within 1e-6 of the magnitude, f64 1e-12.
"""

import ast

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu import generator as jgen
from vexcl_tpu.utils.poisson import poisson_7pt
from vexcl_tpu_torch import generator as tgen
from vexcl_tpu_torch._build import arg_classes
from vexcl_tpu_torch.expr import compile as tcompile
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.triton_emit import assign_source, kernel_key
from vexcl_tpu_torch.ops import triton_reduce_view as trv
from vexcl_tpu_torch.types import code_of

N = 64
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "fc":
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL.get(want.dtype, 1e-6) * scale)
    else:
        np.testing.assert_array_equal(got, want)


# -- fault 1: 0-d tensor leaves ------------------------------------------------

@pytest.mark.parametrize("tdt", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("vdt", [np.float32, np.int64])
def test_zero_d_leaf_promotes_as_jax(ctx1, tctx, tdt, vdt):
    import jax.numpy as jnp

    a = (np.arange(N) % 7 + 1).astype(vdt)
    c = tdt(3)
    jx = vex.vector(data=a, context=ctx1)
    tx = vt.vector(data=a, context=tctx)
    jt, tt = jnp.asarray(c), torch.tensor(c)
    _same(vt.eval(tx + tt), vex.eval(jx + jt))
    _same(vt.eval(tt * tx - 1), vex.eval(jt * jx - 1))
    jx += jt
    tx += tt
    _same(tx.to_numpy(), jx.to_numpy())
    jx[:] = jt
    tx[:] = tt
    _same(tx.to_numpy(), jx.to_numpy())


def test_builtin_of_a_constant(ctx1, tctx):
    a = np.linspace(-1, 1, N).astype(np.float32)
    jx = vex.vector(data=a, context=ctx1)
    tx = vt.vector(data=a, context=tctx)
    _same(vt.eval(vt.sin(2.0) + tx), vex.eval(vex.sin(2.0) + jx))
    _same(vt.eval(vt.pow(vt.fabs(-0.3) + 0.5, tx)),
          vex.eval(vex.pow(vex.fabs(-0.3) + 0.5, jx)))
    js = vex.Reductor(vex.SUM)(vex.sin(2.0) + jx)
    ts = vt.Reductor(vt.SUM)(vt.sin(2.0) + tx)
    assert abs(ts - js) <= 1e-5 * max(1.0, abs(js))
    # f64 and integer vectors take the weak constant at their own type
    b = np.arange(N, dtype=np.float64)
    _same(vt.eval(vt.cos(1.0) * vt.vector(data=b, context=tctx)),
          vex.eval(vex.cos(1.0) * vex.vector(data=b, context=ctx1)))
    i = np.arange(N, dtype=np.int32)
    _same(vt.eval(vt.sqrt(2.0) + vt.vector(data=i, context=tctx)),
          vex.eval(vex.sqrt(2.0) + vex.vector(data=i, context=ctx1)))


# -- fault 2: unsigned and boolean arithmetic ---------------------------------

def _unsigned(dt):
    top = {np.uint16: 1 << 16, np.uint32: 1 << 32, np.uint64: 1 << 64}[dt]
    a = (np.arange(N, dtype=np.uint64) * np.uint64(2654435761)).astype(dt)
    a[:3] = [top // 2, top - 1, top // 2 + 5]
    return a


@pytest.mark.parametrize("dt", [np.uint16, np.uint32, np.uint64])
def test_unsigned_arithmetic(ctx1, tctx, dt):
    a = _unsigned(dt)
    b = a[::-1].copy() | dt(1)
    ja, jb = (vex.vector(data=v, context=ctx1) for v in (a, b))
    ta, tb = (vt.vector(data=v, context=tctx) for v in (a, b))
    for f in (lambda m, x, y: x + x, lambda m, x, y: x - y,
              lambda m, x, y: x * y, lambda m, x, y: x // y,
              lambda m, x, y: x % y, lambda m, x, y: x >> 3,
              lambda m, x, y: x << 2, lambda m, x, y: x < y,
              lambda m, x, y: m.max(x, y), lambda m, x, y: -x,
              lambda m, x, y: m.if_else(x > y, x, y)):
        _same(vt.eval(f(vt, ta, tb)), vex.eval(f(vex, ja, jb)))
    for kind in ("MIN", "MAX", "SUM"):
        assert (vt.Reductor(getattr(vt, kind))(ta)
                == vex.Reductor(getattr(vex, kind))(ja)), kind


def test_boolean_arithmetic(ctx1, tctx):
    b = np.arange(N) % 3 == 0
    t = np.ones(N, dtype=bool)
    jb, jt = (vex.vector(data=v, context=ctx1) for v in (b, t))
    tb, tt = (vt.vector(data=v, context=tctx) for v in (b, t))
    for f in (lambda x, y: abs(x), lambda x, y: x // y, lambda x, y: x % y,
              lambda x, y: x << x, lambda x, y: x >> y):
        _same(vt.eval(f(tb, tt)), vex.eval(f(jb, jt)))


# -- fault 3: complex sums, boolean MIN/MAX -----------------------------------

def test_complex_sum_and_boolean_min_max(ctx1, tctx):
    c = (np.arange(N) + 1j * np.arange(N)[::-1]).astype(np.complex64)
    assert (vt.Reductor(vt.SUM)(vt.vector(data=c, context=tctx))
            == vex.Reductor(vex.SUM)(vex.vector(data=c, context=ctx1)))
    for b in (np.arange(N) % 2 == 0, np.ones(N, dtype=bool)):
        tb = vt.vector(data=b, context=tctx)
        jb = vex.vector(data=b, context=ctx1)
        for kind in ("MIN", "MAX"):
            assert (vt.Reductor(getattr(vt, kind))(tb)
                    == vex.Reductor(getattr(vex, kind))(jb))


# -- a recorded kernel's analysis, kept per binding ---------------------------

def _axpy(gen):
    x, y, a = gen.symbolic(), gen.symbolic(), gen.symbolic()
    y.assign(a * x + y)
    y.assign(y * y + 0.5 * x)
    return gen.build_kernel("axpy2", [y], params=[x, y, a])


def test_kernel_keeps_its_analysis_per_binding(ctx1, tctx, monkeypatch):
    walks = []
    for name in ("analyze", "hoist"):
        fn = getattr(tcompile, name)

        def counted(*a, _fn=fn, _name=name, **k):
            walks.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tcompile, name, counted)
    jk, tk = _axpy(jgen), _axpy(tgen)
    rng = np.random.default_rng(7)
    bindings = []
    for dt, n, a in ((np.float32, 40, 0.5), (np.float64, 72, -1.25)):
        x, y = (rng.normal(size=n).astype(dt) for _ in range(2))
        bindings.append((
            (vex.vector(data=x, context=ctx1),
             vex.vector(data=y, context=ctx1), a),
            (vt.vector(data=x, context=tctx),
             vt.vector(data=y, context=tctx), a)))
    for step in range(6):
        (jx, jy, a), (tx, ty, _) = bindings[step % 2]
        before = len(walks)
        jk(jx, jy, a)
        tk(tx, ty, a)
        _same(ty.to_numpy(), jy.to_numpy())
        if step >= 2:
            assert len(walks) == before, walks[before:]
    assert len(tk._bindings) == 2


def test_kernel_binding_of_another_scalar_kind(ctx1, tctx):
    jk, tk = _axpy(jgen), _axpy(tgen)
    x = np.linspace(0, 1, N).astype(np.float32)
    jx, jy = (vex.vector(data=x, context=ctx1) for _ in range(2))
    tx, ty = (vt.vector(data=x, context=tctx) for _ in range(2))
    for a in (2, 0.25, 3):
        jk(jx, jy, a)
        tk(tx, ty, a)
        _same(ty.to_numpy(), jy.to_numpy())
    assert len(tk._bindings) == 2          # an int and a float


# -- V2's kept schedule ----------------------------------------------------------

_SHAPES = [((8, 8), (0,)), ((8, 8), (1,)), ((4, 4, 4), (0, 2)),
           ((4, 4, 4), (1,)), ((4, 4, 4), (0, 1, 2)), ((4096, 4096), (1,)),
           ((4096, 4096), (0,)), ((256, 256, 256), (2,)), ((4096, 33), (0,)),
           ((3, 5000), (1,)), ((20000, 1), (0,)), ((64, 512, 3), (0, 2))]


@pytest.mark.parametrize("shape,axes", _SHAPES)
@pytest.mark.parametrize("itemsize", [1, 4, 8])
def test_reduce_view_schedule_is_the_plan(shape, axes, itemsize):
    kc, kf, rc, rf, r_fast, pattern = trv._layout(shape, axes)
    n_out, nred = int(np.prod(kc)), int(np.prod(rc))
    pl = trv.plan(n_out, nred, r_fast, itemsize, 528)
    for _ in range(2):                    # computed, then kept
        sch = trv.schedule(shape, axes, itemsize, 528)
        assert sch.plan == pl and sch.pattern == pattern
        assert sch.n_out == n_out
        assert sch.ints == (n_out, nred, pl.chunk, pl.nsplit, *kc[1:], *kf,
                            *rc[1:], *rf)


# -- Ap[:] = A * p into its target --------------------------------------------

def test_spmv_writes_into_its_target(ctx1, tctx, monkeypatch):
    from vexcl_tpu_torch.sparse.spmat import SpMVExpr

    ptr, col, val = poisson_7pt(6, dtype=np.float64)
    n = 216
    jA = vex.SpMat(n, n, ptr, col, val, context=ctx1)
    tA = vt.SpMat(n, n, ptr, col, val, context=tctx)
    p = np.random.default_rng(3).normal(size=n)
    jp, tp = vex.vector(data=p, context=ctx1), vt.vector(data=p, context=tctx)
    jAp = vex.vector(n, dtype=np.float64, context=ctx1)
    tAp = vt.vector(n, dtype=np.float64, context=tctx)
    outs = []
    real = SpMVExpr.materialize

    def spy(self, device, n=None, out=None):
        outs.append(out)
        return real(self, device, n, out=out)
    monkeypatch.setattr(SpMVExpr, "materialize", spy)
    ptr_before = tAp.storage.data_ptr()
    jAp[:] = jA * jp
    tAp[:] = tA * tp
    _same(tAp.to_numpy(), jAp.to_numpy())
    assert outs[-1] is tAp.storage and tAp.storage.data_ptr() == ptr_before
    # x[:] = A * x reads its target: a temporary, then the copy
    jp[:] = jA * jp
    tp[:] = tA * tp
    _same(tp.to_numpy(), jp.to_numpy())
    assert outs[-1] is None


# -- a 0-d leaf in the kernel source and key ------------------------------------

def test_zero_d_leaf_source_and_key(tctx):
    x = vt.vector(data=np.arange(8, dtype=np.float32), context=tctx)
    t0 = torch.tensor(2.0)
    e, an, ty, lv = prepare(x + t0, 8, torch.device("cpu"))
    src = assign_source(e, an, ty, "f32")
    ast.parse(src)
    slot = an.slot_of[id(e.children[1])]
    assert f"tl.load(p{slot})" in src            # one load, broadcast
    # a 0-d CPU tensor in a CUDA evaluation crosses as a numpy scalar of
    # its type: another kernel (a scalar parameter), another key
    crossed = list(an.leaves)
    crossed[slot] = tcompile._scalar_leaf(t0, torch.device("meta"))
    assert isinstance(crossed[slot], np.float32)
    an.leaves = crossed
    assert kernel_key(an, (torch.float32,))[1][slot] == "f32"
    assert f"v{slot} = s{slot}.to(tl.float32)" in assign_source(e, an, ty,
                                                                "f32")
    e1, an1, _, _ = prepare(x + x, 8, torch.device("cpu"))
    assert kernel_key(an1, (torch.float32,)) != kernel_key(
        an, (torch.float32,))


def test_launch_argument_classes():
    """The launch records' classes: a pointer's 16-byte alignment, an
    integer's width, and a specialised integer's == 1 and % 16."""
    base = torch.zeros(64, dtype=torch.float32)
    c0 = arg_classes([base, 7], (True, True))
    assert c0 != arg_classes([base[1:], 7], (True, True))
    assert c0 == arg_classes([base[4:], 7], (True, True))
    assert arg_classes([3.5], (True,)) == arg_classes([-1e300], (False,))
    spec = {v: arg_classes([v], (True,)) for v in (
        1, 2, 16, 17, 32, (1 << 31) - 1, 1 << 31, -3, 1 << 63)}
    assert spec[2] == spec[17] == spec[(1 << 31) - 1] == spec[-3]
    assert spec[16] == spec[32]
    assert len({spec[1], spec[2], spec[16], spec[1 << 31],
                spec[1 << 63]}) == 5
    plain = [arg_classes([v], (False,)) for v in (2, 16, 1 << 31, 1 << 63)]
    assert plain[0] == plain[1] and len(set(plain)) == 3
    assert arg_classes([True], (True,)) != arg_classes([1], (True,))


class _FakeLauncher:
    """Stands for Triton's ``CudaLauncher``: its C entry point records its
    calls."""

    global_scratch_size = profile_scratch_size = 0
    launch_cooperative_grid = launch_pdl = False

    def __init__(self, calls):
        self.launch = lambda *a: calls.append(("direct", a))


class _FakeKernel:
    """Stands for a ``CompiledKernel``."""

    def __init__(self, calls):
        self.function, self.packed_metadata = "handle", (4, 1, 0)
        self.run = _FakeLauncher(calls)


class _FakeJit:
    """Stands for a ``JITFunction`` of (o0, p0, s1, n, BLOCK): ``fn[grid]``
    records its calls and returns a fake compiled kernel."""

    class _P:
        def __init__(self, name, dns=False, const=False):
            self.name, self.do_not_specialize = name, dns
            self.is_constexpr = const

    def __init__(self):
        self.params = [self._P("o0"), self._P("p0"), self._P("s1", True),
                       self._P("n"), self._P("BLOCK", const=True)]
        self.calls = []

    def __getitem__(self, grid):
        def run(*args, **kw):
            self.calls.append(("jit", grid, args, kw))
            return _FakeKernel(self.calls)
        return run


def test_launch_records_without_a_card(monkeypatch):
    """The first call of a class goes through ``fn[grid]`` and keeps its
    compiled kernel; later calls of the class go to its launcher's entry
    point with pointers as integers, the raw stream and the constexprs
    last; a pointer of another alignment or a count of another class
    makes a new record."""
    from vexcl_tpu_torch._build import TritonLauncher

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 77, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    fn = _FakeJit()
    lau = TritonLauncher(fn, num_warps=4)
    assert lau.specialized == (True, True, False, True)
    assert lau.constexprs == ("BLOCK",)
    dev = torch.device("cuda", 0)
    buf = torch.zeros(64)
    o, p = buf[:16], buf[16:32]
    lau((2,), [o, p, 12345], (1000,), (1024,), dev)
    lau((2,), [o, p, 999], (1000,), (1024,), dev)
    assert [c[0] for c in fn.calls] == ["jit", "direct"]
    _, grid, args, kw = fn.calls[0]
    assert grid == (2,) and args == (o, p, 12345, 1000)
    assert kw == {"BLOCK": 1024, "num_warps": 4}
    direct = fn.calls[1][1]
    assert direct[:13] == (2, 1, 1, 77, "handle", False, False, None, None,
                           (4, 1, 0), None, None, None)
    assert direct[13:] == (o.data_ptr(), p.data_ptr(), 999, 1000, 1024)
    lau((2,), [o, buf[17:33], 999], (1000,), (1024,), dev)   # misaligned
    lau((2,), [o, p, 999], (1008,), (1024,), dev)            # n % 16 == 0
    lau((2,), [o, p, 1 << 40], (1000,), (1024,), dev)        # an i64 scalar
    lau((2,), [o, p, 5], (1000,), (1024,), dev)
    assert [c[0] for c in fn.calls] == ["jit", "direct", "jit", "jit",
                                        "jit", "direct"]
    assert len(lau.records) == 4
