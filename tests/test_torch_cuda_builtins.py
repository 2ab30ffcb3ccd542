"""The builtins' kernel forms (every catalog entry in f32 and f64, the
integer helpers, integer ``**``, boolean arithmetic), expressions with
compound operators and scalar leaves, integer floor division, the
saturating float-to-integer casts, and the generator's backward kernel
(gradients, vmap, digamma) against their plain versions on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_builtins.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.builtins import KERNEL_BUILTINS
from vexcl_tpu_torch.expr.compile import prepare_multi
from vexcl_tpu_torch.expr.triton_emit import assign_multi, assign_multi_plain
from _grad_tables import GRAD_DOMAIN, NOT_DIFFERENTIABLE
from chip_smoke import BUILTIN_DOMAIN, BUILTIN_INTEGER
from _cuda_common import (N, RTOL, gpu, _vec, _both, _close, _close_each,
                          _kernels_launched)

pytestmark = pytest.mark.cuda


def _builtin_args(ctx, name, dt, rng, n=N):
    """Vectors for one builtin of the sweep: floats of dt over its
    domain; integers (i32 for f32, i64 for f64; i16 and i32 for
    ``upsample``, which widens them) for the integer helpers; an i32
    exponent for ``ldexp``."""
    k = vex.BUILTINS[name].nargs
    if name in BUILTIN_INTEGER:
        npdt = np.int32 if dt == torch.float32 else np.int64
        if name == "upsample":
            npdt = np.int16 if dt == torch.float32 else np.int32
        return [vex.vector(data=rng.integers(-1000, 1000, n).astype(npdt),
                           context=ctx) for _ in range(k)]
    lo, hi = BUILTIN_DOMAIN.get(name, (-3, 3))
    npdt = np.float64 if dt == torch.float64 else np.float32
    args = [vex.vector(data=(lo + (hi - lo) * rng.random(n)).astype(npdt),
                       context=ctx) for _ in range(k)]
    if name == "ldexp":
        args[1] = vex.vector(data=rng.integers(-20, 20, n).astype(np.int32),
                             context=ctx)
    return args


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", KERNEL_BUILTINS)
def test_builtin_kernel_matches_plain(gpu, name, dt):
    fn = vex.BUILTINS[name]
    args = _builtin_args(gpu, name, dt, np.random.default_rng(1))
    expr = vex.as_expr(fn(*args))
    res_dt = vex.eval(expr).dtype
    k, p = _both(expr, N, res_dt, gpu.device)
    if not res_dt.is_floating_point:
        assert torch.equal(k, p)
    else:
        _close_each(k, p, 4 * RTOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_expression_and_compound_kernels(gpu, dt):
    rng = np.random.default_rng(2)
    npdt = np.float64 if dt == torch.float64 else np.float32
    a, b, c, d = (_vec(gpu, rng.standard_normal(N).astype(npdt))
                  for _ in range(4))
    k, p = _both(2 * b + vex.sin(c), N, dt, gpu.device)
    _close(k, p, RTOL[dt])
    ref = a.storage + (b.storage + c.storage * d.storage)
    a += b + c * d
    _close(a.storage, ref, RTOL[dt])
    # an f64 scalar keeps all its bits in an f64 expression
    x = _vec(gpu, np.zeros(N, npdt))
    x[:] = x + 0.1
    assert x[0] == (0.1 if dt == torch.float64 else float(np.float32(0.1)))
    x[:] = vex.if_else(b > 0, vex.cast(torch.int32, c * 10), d)
    e = torch.where(b.storage > 0, (c.storage * 10).to(torch.int32).to(dt),
                    d.storage)
    _close(x.storage, e, RTOL[dt])
    x[:] = vex.element_index() * 0.5 + vex.constants.pi()
    _close(x.storage, torch.arange(N, device=gpu.device, dtype=dt) * 0.5
           + np.pi, RTOL[dt])


def test_scalar_leaves_keep_their_values(gpu):
    """Scalars cross into the kernel in their own type: f64 values as
    their bits (0.0 and negatives included), numpy f32, ints, bools."""
    x = _vec(gpu, np.arange(N, dtype=np.float64))
    for s in (0.0, -0.0, -2.5, 1e-310, 1e300, np.float32(0.1), 3, -7,
              2 ** 40, True):
        k, p = _both(x * 0 + s, N, torch.float64, gpu.device)
        assert torch.equal(k, p), s
    i = _vec(gpu, np.arange(N, dtype=np.int32) - N // 2)
    for s in (0, 1, -1, 2 ** 20):
        k, p = _both(i * s + 1, N, torch.int32, gpu.device)
        assert torch.equal(k, p), s


def test_integer_floor_semantics_kernel(gpu):
    rng = np.random.default_rng(3)
    a = _vec(gpu, rng.integers(-50, 50, N).astype(np.int32))
    b = _vec(gpu, rng.choice([-7, -3, 2, 5], N).astype(np.int32))
    for e in (a // b, a % b, a // -3, a % 4, -a % b):
        k, p = _both(e, N, torch.int32, gpu.device)
        assert torch.equal(k, p)
    f = _vec(gpu, rng.standard_normal(N) * 10)
    g = _vec(gpu, rng.choice([-2.5, 1.5, 3.0], N))
    for e in (f // g, f % g):
        k, p = _both(e, N, torch.float64, gpu.device)
        _close(k, p, 1e-12)


# -- the builtins' kernel forms on integer types, integer pow, boolean
# arithmetic, advanced slicer keys and image samples --------------------

_INT_TYPES = [torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.uint16, torch.uint32, torch.uint64]
_NP_INT = {torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
           torch.int64: np.int64, torch.uint8: np.uint8,
           torch.uint16: np.uint16, torch.uint32: np.uint32,
           torch.uint64: np.uint64}


def _int_data(n, dt, seed):
    """Random values over all of dt, after its least and largest values,
    0, 1 and (signed) -1."""
    npdt = _NP_INT[dt]
    info = np.iinfo(npdt)
    rng = np.random.default_rng(seed)
    h = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    special = [info.min, info.max, 0, 1] + ([-1] if info.min < 0 else [])
    h[:len(special)] = np.array(special, dtype=object).astype(npdt)
    return h


#: the integer helpers and builtins that keep an integer type: arity
_INT_BUILTINS = {"popcount": 1, "clz": 1, "__popc": 1, "__popcll": 1,
                 "rotate": 2, "add_sat": 2, "sub_sat": 2, "mul_hi": 2,
                 "mad_hi": 3, "mad_sat": 3, "upsample": 2, "maxmag": 2,
                 "minmag": 2, "step": 2, "any": 1, "all": 1, "select": 3,
                 "hadd": 2, "bitselect": 3, "signbit": 1, "isnormal": 1,
                 "min": 2, "max": 2, "clamp": 3, "sign": 1, "abs": 1}


@pytest.mark.parametrize("name,dt", [
    (name, dt) for name in sorted(_INT_BUILTINS) for dt in _INT_TYPES
    if not (name == "upsample" and dt.itemsize == 8)])
def test_integer_builtin_kernel_bitwise(gpu, name, dt):
    """Each builtin over random bits of every integer type (the type's
    extremes, 0, 1 and -1 first), bitwise against its plain form."""
    n = 20000
    args = [vex.vector(data=_int_data(n, dt, 50 + i), context=gpu)
            for i in range(_INT_BUILTINS[name])]
    expr = vex.as_expr(vex.BUILTINS[name](*args))
    k, p = _both(expr, n, vex.eval(expr).dtype, gpu.device)
    assert torch.equal(k, p), name


@pytest.mark.parametrize("dt", _INT_TYPES)
def test_integer_pow_kernel_bitwise(gpu, dt):
    """Integer ** (square and multiply over the exponent's bits) at
    exponents -3..40 (0..40 unsigned), wrapping, bitwise against PyTorch's
    integer pow; also by a scalar exponent and of a scalar base."""
    n = 20000
    npdt = _NP_INT[dt]
    info = np.iinfo(npdt)
    rng = np.random.default_rng(41)
    lo = -3 if info.min < 0 else 0
    base = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                        n).astype(npdt)
    base[:6] = np.array([0, 1, 2, 3, 1, 0]).astype(npdt)
    if info.min < 0:
        base[6:9] = np.array([-1, -2, -3]).astype(npdt)
    exps = rng.integers(lo, 41, n).astype(npdt)
    a = vex.vector(data=base, context=gpu)
    b = vex.vector(data=exps, context=gpu)
    for expr in (a ** b, a ** 3, a ** 40, 2 ** b, a ** b + 1):
        k, p = _both(expr, n, dt, gpu.device)
        assert torch.equal(k, p)


def test_boolean_arithmetic_kernel_bitwise(gpu):
    """Operators and builtins on booleans give what their plain forms give
    (+ is or, * is and; //, %, ** in i32; orders on 0 and 1); - and
    unary - raise TypeError, as PyTorch refuses them."""
    n = 5000
    rng = np.random.default_rng(42)
    b, c, d = (vex.vector(data=rng.random(n) < 0.5, context=gpu)
               for _ in range(3))
    exprs = [b + c, b * c, b * c + d, vex.mad(b, c, d), vex.fma(b, c, d),
             vex.mul24(b, c), vex.mad24(b, c, d), vex.hadd(b, c),
             vex.min(b, c), vex.max(b, c), vex.clamp(b, c, d),
             vex.maxmag(b, c), vex.minmag(b, c), vex.step(b, c), b ** c,
             b // c, b % c, vex.select(b, c, d), b & c, b | c, b ^ c, ~b,
             b == c, b < c, b >= c, vex.isless(b, c), b + 1, b * 2.5,
             vex.rotate(b, c)]
    for e in exprs:
        e = vex.as_expr(e)
        k, p = _both(e, n, vex.eval(e).dtype, gpu.device)
        assert torch.equal(k, p)
    y = vex.vector(n, dtype=torch.bool, context=gpu)
    for e in (lambda: b - c, lambda: -b):
        with pytest.raises(TypeError):
            y[:] = e()


# -- saturating float-to-integer casts, and the generator's backward kernel

_CAST_SOURCES = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
                 torch.complex64, torch.complex128]
_CAST_TARGETS = [torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8, torch.uint16, torch.uint32, torch.uint64]


def _cast_values(src, n=(1 << 14) + 77):
    """Values of type src: NaN, the infinities, -0.5, +-3.7, every integer
    type's limits with their neighbours in the source type, and random
    values spread over +-2^70 (each sign, every scale)."""
    real = src.to_real() if src.is_complex else src
    rng = np.random.default_rng(40)
    lims = []
    for t in _CAST_TARGETS:
        info = torch.iinfo(t)
        lims += [float(info.min), float(info.max)]
    lims = torch.tensor(lims, dtype=torch.float64).to(real)
    inf = torch.full_like(lims, float("inf"))
    special = torch.cat([torch.tensor([float("nan"), float("inf"),
                                       -float("inf"), -0.5, 3.7, -3.7, 0.0,
                                       -0.0], dtype=real), lims,
                         torch.nextafter(lims, inf),
                         torch.nextafter(lims, -inf)])
    wide = torch.from_numpy(rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(
        -2, 70, n)).to(real)
    x = torch.cat([special, wide])
    if src.is_complex:
        x = torch.complex(x, x.flip(0))
    return x


@pytest.mark.parametrize("src", _CAST_SOURCES)
def test_saturating_casts_kernel_bitwise(gpu, src):
    """Every float (and complex) type into every integer type, through
    ``cast`` and through the store of an assignment, in one k-output
    kernel: the kernel's clamps equal the plain form's bit for bit."""
    x = _vec(gpu, _cast_values(src).to(gpu.device))
    n = x.size
    for make in (lambda t: vex.cast(t, x), lambda t: vex.as_expr(x)):
        exprs = [make(t) for t in _CAST_TARGETS]
        e, an, ty, lv = prepare_multi(exprs, n, gpu.device)
        k = [torch.empty(n, dtype=t, device=gpu.device)
             for t in _CAST_TARGETS]
        p = [torch.empty_like(o) for o in k]
        assign_multi(e, an, ty, lv, k)
        assign_multi_plain(e, an, ty, lv, p)
        torch.cuda.synchronize()
        for t, a, b in zip(_CAST_TARGETS, k, p):
            assert torch.equal(a.cpu(), b.cpu()), (src, t)


def _grad_kernel(name, nargs):
    """The kernel ``y = name(p0, ..)`` of the generator and its params."""
    from vexcl_tpu_torch import generator as tgen

    params = [tgen.symbolic() for _ in range(nargs)]
    y = tgen.symbolic()
    y[:] = vex.BUILTINS[name](*params)
    return tgen.build_kernel(name, [y], params)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(set(vex.BUILTINS)
                                        - NOT_DIFFERENTIABLE))
def test_backward_kernel_matches_plain(gpu, name, dt):
    """Each differentiable builtin's backward kernel (the adjoint tree in
    one K1 launch) against its plain version, element by element, and
    the gradients through autograd equal to the kernel's."""
    rng = np.random.default_rng(41)
    kernel = _grad_kernel(name, vex.BUILTINS[name].nargs)
    lo, hi = GRAD_DOMAIN.get(name, (-3.0, 3.0))
    args = [torch.from_numpy(rng.uniform(lo, hi, N)).to(gpu.device, dt)
            for _ in range(vex.BUILTINS[name].nargs)]
    if name == "ldexp":
        args[1] = torch.from_numpy(rng.integers(-20, 20, N)).to(
            gpu.device, torch.int32)
    cot = torch.from_numpy(rng.uniform(0.5, 1.5, N)).to(gpu.device, dt)
    needs = [a.dtype.is_floating_point for a in args]
    bk = kernel.backward_kernel(args, [cot], needs)
    got = bk.as_function()(*args, cot)
    want = bk.plain(*args, cot)
    for g, w in zip(got, want):
        _close_each(g, w, 4 * RTOL[dt])
    ts = [a.clone().requires_grad_(need) for a, need in zip(args, needs)]
    (out,) = kernel.as_function()(*ts)
    auto = torch.autograd.grad(out, [t for t in ts if t.requires_grad], cot)
    for g, a in zip(got, auto):
        assert torch.equal(g, a)


def test_backward_is_one_launch_a_call(gpu):
    """A backward call of the Lorenz step is one launch of the backward
    kernel (the counter and the profiler); with a 0-d parameter, two: K1
    for the vectors' gradients, K2 for the 0-d one's."""
    from vexcl_tpu_torch import generator as tgen
    from vexcl_tpu_torch.models import LorenzEnsemble
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce_multi

    ens = LorenzEnsemble(1 << 16, context=gpu)
    fn = ens._step.as_function()
    xs = [v.storage.clone().requires_grad_() for v in (ens.x, ens.y, ens.z,
                                                       ens.R)]
    w = torch.rand(1 << 16, device=gpu.device)

    def grads():
        x, y, z, R = xs
        for _ in range(3):
            x, y, z = fn(x, y, z, R)
        return torch.autograd.grad((w * (x + y + z)).sum(), xs)

    grads()
    tgen.backward.launches = assign_multi.launches = 0
    grads()
    torch.cuda.synchronize()
    assert tgen.backward.launches == 3 and assign_multi.launches == 6
    # the backward kernel alone: one kernel a call
    out = fn(*xs)
    launched = _kernels_launched(lambda: torch.autograd.grad(
        out, xs, [w, w, w], retain_graph=True), reps=2)
    assert [c for k, c in launched if "assign_kernel" in k] == [2], launched
    # a 0-d parameter: K1 and K2
    x = torch.rand(1 << 16, device=gpu.device, requires_grad=True)
    a = torch.tensor(1.5, device=gpu.device, requires_grad=True)
    kernel = _grad_kernel("mad", 3)
    (y,) = kernel.as_function()(x, a, x)
    tgen.backward.launches = map_reduce_multi.launches = 0
    assign_multi.launches = 0
    gx, ga = torch.autograd.grad(y, (x, a), w)
    torch.cuda.synchronize()
    assert tgen.backward.launches == 2 and map_reduce_multi.launches == 1
    assert assign_multi.launches == 1
    assert torch.equal(gx, w * a.detach() + w)
    _close(ga.reshape(1), (w * x.detach()).sum().reshape(1), 1e-5)


def test_vmap_kernel_matches_unbatched_calls(gpu):
    """torch.func.vmap over a (4, n) batch is one launch and equals four
    unbatched calls bit for bit."""
    from vexcl_tpu_torch.models import LorenzEnsemble

    ens = LorenzEnsemble(1 << 16, context=gpu)
    fn = ens._step.as_function()
    y, z, R = (v.storage for v in (ens.y, ens.z, ens.R))
    xb = torch.rand(4, 1 << 16, device=gpu.device)
    assign_multi.launches = 0
    got = torch.func.vmap(lambda u: fn(u, y, z, R))(xb)
    assert assign_multi.launches == 1
    for i in range(4):
        one = fn(xb[i], y, z, R)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_digamma_kernel_matches_plain(gpu, dt):
    """lgamma's derivative (``builtins.DIGAMMA``): the kernel form against
    torch.digamma, at the poles and zeros too."""
    from vexcl_tpu_torch.expr.builtins import DIGAMMA

    rng = np.random.default_rng(42)
    x = np.concatenate([[0.0, -0.0, -1.0, -2.0, 10.0, float("inf"),
                         -float("inf"), float("nan"), 1e18, 1e-30],
                        rng.uniform(-6.0, 12.0, N)])
    v = _vec(gpu, torch.from_numpy(x).to(dt))
    k, p = _both(vex.as_expr(DIGAMMA(v)), v.size, dt, gpu.device)
    _close_each(k, p, 4 * RTOL[dt])
