"""Gradients and vmap through the port's symbolic generator against
vexcl_tpu's.

``Kernel.as_function()`` of the JAX package is a JAX function:
``jax.grad`` and ``jax.vmap`` compose through it
(``tests/test_generator_mba_profiler.py:251-285``).  The port's composes
with ``torch.autograd``, ``torch.func.grad`` and ``torch.func.vmap``: its
backward is the adjoint of the recorded trees (``expr/adjoint.py``),
which on the CPU runs through the trees' plain forms, so these tests hold
the symbolic derivative itself against JAX's autodiff.  The same seeded
numpy inputs go through both packages (x64 on the JAX side).

Tolerances: f64 1e-10 relative to each value's magnitude (absolute below
1), the reference test's own; f32 2e-5 (a few ulp of the two libraries'
math, through the rule's few operations), and 1e-4 for Lorenz after three
steps.  The inputs are interior points of each builtin's domain, away
from its kinks, with results that are normal numbers (XLA on the CPU
flushes subnormals to zero); the kinks are held separately, at JAX's own
values.
"""

import math

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu import generator as jgen
from vexcl_tpu.models import LorenzEnsemble as JLorenz
from vexcl_tpu_torch import generator as tgen
from vexcl_tpu_torch.models import LorenzEnsemble
from _grad_tables import GRAD_DOMAIN, NOT_DIFFERENTIABLE

TOL = {np.float32: 2e-5, np.float64: 1e-10}

DIFFERENTIABLE = sorted(set(vt.BUILTINS) - NOT_DIFFERENTIABLE)


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0.0) <= tol, err.max()


def _kernel(gen, m, body, nargs):
    """The kernel ``y = body(m, *params)`` recorded in package ``m`` with
    generator ``gen``."""
    params = [gen.symbolic() for _ in range(nargs)]
    y = gen.symbolic()
    y[:] = body(m, *params)
    return gen.build_kernel("f", [y], params)


def _function(gen, m, body, nargs):
    """``fn(*arrays) -> (body(*params),)`` of that kernel."""
    return _kernel(gen, m, body, nargs).as_function()


def _jax_grads(fn, arrays, w, argnums):
    import jax
    import jax.numpy as jnp

    def loss(*a):
        return jnp.sum(jnp.asarray(w) * fn(*a)[0])

    return jax.grad(loss, argnums=argnums)(*[jnp.asarray(a)
                                              for a in arrays])


def _torch_grads(fn, arrays, w, argnums):
    ts = [torch.tensor(a, requires_grad=i in argnums)
          for i, a in enumerate(arrays)]
    (out,) = fn(*ts)
    return torch.autograd.grad((torch.from_numpy(w) * out).sum(),
                               [ts[i] for i in argnums])


def test_reference_tree_gradient_and_vmap(tctx):
    """The reference test's tree ``y = sin(x)*a + x*x``: the gradient of
    sum(fn(x, a)**2) in x (a = 2.0, a Python number) to 1e-10, in x and
    a with a 0-d tensor, and vmap over a (4, 16) batch."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(301)
    hx = rng.random(16)

    def body(m, x, a):
        return m.sin(x) * a + x * x

    jf, tf = _function(jgen, vex, body, 2), _function(tgen, vt, body, 2)
    want = jax.grad(lambda x: jnp.sum(jf(x, 2.0)[0] ** 2))(jnp.asarray(hx))
    x = torch.tensor(hx, requires_grad=True)
    (got,) = torch.autograd.grad((tf(x, 2.0)[0] ** 2).sum(), x)
    f = np.sin(hx) * 2.0 + hx * hx
    _close(got.numpy(), 2 * f * (np.cos(hx) * 2.0 + 2 * hx), 1e-10)
    _close(got.numpy(), want, 1e-10)
    # the same through torch.func.grad
    got = torch.func.grad(lambda u: (tf(u, 2.0)[0] ** 2).sum())(
        torch.from_numpy(hx))
    _close(got.numpy(), want, 1e-10)
    # a as a 0-d tensor: its gradient is the sum over the elements
    wx, wa = jax.grad(lambda x, a: jnp.sum(jf(x, a)[0] ** 2),
                      argnums=(0, 1))(jnp.asarray(hx), jnp.asarray(2.0))
    x = torch.tensor(hx, requires_grad=True)
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    gx, ga = torch.autograd.grad((tf(x, a)[0] ** 2).sum(), (x, a))
    assert ga.shape == () and ga.dtype == torch.float64
    _close(gx.numpy(), wx, 1e-10)
    _close(ga.numpy(), wa, 1e-10)
    # vmap over a batch of 4
    hb = rng.random((4, 16))
    want = jax.vmap(lambda u: jf(u, 2.0)[0])(jnp.asarray(hb))
    got = torch.func.vmap(lambda u: tf(u, 2.0)[0])(torch.from_numpy(hb))
    assert got.shape == (4, 16)
    _close(got.numpy(), want, 1e-12)


def test_vmap_batch_axes_and_unbatched_vectors(tctx):
    """vmap with the batch on axis 1, an unbatched vector repeated over
    the batch, and a batched 0-d argument, against jax.vmap."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(302)
    hx, hy, ha = rng.random((16, 3)), rng.random(16), rng.random(3)

    def body(m, x, y, a):
        return m.exp(x) * a - y

    jf, tf = _function(jgen, vex, body, 3), _function(tgen, vt, body, 3)
    want = jax.vmap(lambda x, a: jf(x, jnp.asarray(hy), a)[0],
                    in_axes=(1, 0))(jnp.asarray(hx), jnp.asarray(ha))
    got = torch.func.vmap(lambda x, a: tf(x, torch.from_numpy(hy), a)[0],
                          in_dims=(1, 0))(torch.from_numpy(hx),
                                          torch.from_numpy(ha))
    assert got.shape == (3, 16)
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_lorenz_gradients_after_three_steps(ctx1, tctx, dt):
    """LorenzEnsemble(64) in both packages from one state: the gradient of
    sum(w (x_T + y_T + z_T)) after 3 steps in x0, y0, z0 and R."""
    jm = JLorenz(64, dtype=dt, context=ctx1)
    state = [np.array(np.asarray(v), dt) for v in (*jm.state(), jm.R)]
    tm = LorenzEnsemble.from_arrays(*state, context=tctx)
    w = np.random.default_rng(303).random(64).astype(dt)
    jfn, tfn = jm._step.as_function(), tm._step.as_function()

    def run(fn, x, y, z, R):
        for _ in range(3):
            x, y, z = fn(x, y, z, R)
        return x + y + z

    import jax
    import jax.numpy as jnp

    want = jax.grad(lambda *s: jnp.sum(jnp.asarray(w) * run(jfn, *s)),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, state))
    ts = [torch.tensor(s, requires_grad=True) for s in state]
    got = torch.autograd.grad((torch.from_numpy(w) * run(tfn, *ts)).sum(),
                              ts)
    for g, v in zip(got, want):
        assert g.dtype == vt.dtype_of(dt)
        _close(g.numpy(), v, 1e-10 if dt == np.float64 else 1e-4)


def _operands(name, dt, rng, n=32):
    lo, hi = GRAD_DOMAIN.get(name, (-3.0, 3.0))
    args = [rng.uniform(lo, hi, n).astype(dt)
            for _ in range(vt.BUILTINS[name].nargs)]
    if name == "ldexp":
        args[1] = rng.integers(-4, 5, n).astype(np.int32)
    return args


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_builtin_gradient_matches_jax(tctx, name, dt):
    """Each differentiable catalog entry as a one-builtin kernel: the
    gradient of sum(w f(...)) in each float operand against jax.grad of
    vexcl_tpu's kernel."""
    rng = np.random.default_rng(abs(hash(name)) % (1 << 31))
    args = _operands(name, dt, rng)
    w = rng.uniform(0.5, 1.5, len(args[0])).astype(dt)
    nums = [i for i, a in enumerate(args) if a.dtype.kind == "f"]

    def body(m, *p):
        return m.BUILTINS[name](*p)

    jf = _function(jgen, vex, body, len(args))
    tf = _function(tgen, vt, body, len(args))
    want = _jax_grads(jf, args, w, tuple(nums))
    got = _torch_grads(tf, args, w, nums)
    for g, v in zip(got, want):
        assert g.dtype == vt.dtype_of(dt)
        _close(g.numpy(), v, TOL[dt])


#: JAX's gradients at the kinks, at x = -1, 0, 1, 2
KINKS = {
    "fabs": (lambda m, x: m.fabs(x), [-1, 1, 1, 1]),
    "fmax": (lambda m, x: m.fmax(x, 1.0), [0, 0, 0.5, 1]),
    "fmin": (lambda m, x: m.fmin(x, 1.0), [1, 1, 0.5, 0]),
    "clamp": (lambda m, x: m.clamp(x, 0.0, 1.0), [0, 0.5, 0.5, 0]),
    "fdim": (lambda m, x: m.fdim(x, 1.0), [0, 0, 0.5, 1]),
    "sqrt": (lambda m, x: m.sqrt(x), [math.nan, math.inf, 0.5,
                                      0.5 / math.sqrt(2.0)]),
    "cast": (lambda m, x: m.cast(np.int32, x) * 1.0 + x, [1, 1, 1, 1]),
    "abs_operator": (lambda m, x: abs(x * 1.0), [-1, 1, 1, 1]),
    "max_tie": (lambda m, x: m.max(x, x), [1, 1, 1, 1]),
    "ldexp": (lambda m, x: m.ldexp(x, 2), [4, 1, 4, 4]),
}


@pytest.mark.parametrize("kink", sorted(KINKS))
def test_gradient_at_kinks_matches_jax(tctx, kink):
    body, expect = KINKS[kink]
    hx = np.array([-1.0, 0.0, 1.0, 2.0])
    jf = _function(jgen, vex, body, 1)
    tf = _function(tgen, vt, body, 1)
    w = np.ones(4)
    (want,) = _jax_grads(jf, [hx], w, (0,))
    (got,) = _torch_grads(tf, [hx], w, [0])
    _close(got.numpy(), want, 1e-12)
    _close(got.numpy(), np.array(expect, np.float64), 1e-12)


def test_second_order_matches_jax(tctx):
    """torch.autograd.grad(..., create_graph=True) twice against
    jax.grad(jax.grad(...)), in a vector x and a 0-d a."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(304)
    hx = rng.uniform(-1.0, 1.0, 24)
    w = rng.uniform(0.5, 1.5, 24)

    def body(m, x, a):
        return m.exp(x) * m.sin(a * x) + x * x * x / a

    jf, tf = _function(jgen, vex, body, 2), _function(tgen, vt, body, 2)

    def jgrad(x, a):
        return jax.grad(lambda u, b: jnp.sum(jnp.asarray(w) * jf(u, b)[0]),
                        argnums=(0, 1))(x, a)

    wx, wa = jax.grad(lambda x, a: jnp.sum(jgrad(x, a)[0] * x)
                      + jgrad(x, a)[1], argnums=(0, 1))(
        jnp.asarray(hx), jnp.asarray(1.3))
    x = torch.tensor(hx, requires_grad=True)
    a = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    (out,) = tf(x, a)
    gx, ga = torch.autograd.grad((torch.from_numpy(w) * out).sum(), (x, a),
                                 create_graph=True)
    hx_, ha_ = torch.autograd.grad((gx * x).sum() + ga, (x, a))
    _close(hx_.numpy(), wx, 1e-10)
    _close(ha_.numpy(), wa, 1e-10)


def test_no_gradient_through_integers(ctx1, tctx):
    """An integer input and a cast to an integer type carry no gradient
    (JAX's float0, compared as zeros): d/dx of n*x + cast(i32, 3x) is n."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(305)
    hx, hn = rng.random(16), rng.integers(-5, 5, 16).astype(np.int32)

    def body(m, x, k):
        return k * x + m.cast(np.int32, 3.0 * x)

    jf, tf = _function(jgen, vex, body, 2), _function(tgen, vt, body, 2)
    wx, wn = jax.grad(lambda x, k: jnp.sum(jf(x, k)[0]), argnums=(0, 1),
                      allow_int=True)(jnp.asarray(hx), jnp.asarray(hn))
    assert wn.dtype == jax.dtypes.float0
    x = torch.tensor(hx, requires_grad=True)
    k = torch.from_numpy(hn)
    (out,) = tf(x, k)
    (gx,) = torch.autograd.grad(out.sum(), x)
    _close(gx.numpy(), wx, 1e-12)
    _close(gx.numpy(), hn.astype(np.float64), 1e-12)
    assert not out.requires_grad or out.dtype.is_floating_point


def test_nextafter_and_uncovered_nodes_raise(tctx):
    """Where JAX defines no derivative, or the adjoint would need a kernel
    of its own (a gather's is a scatter, a reduction's a broadcast), a
    gradient asked through the node raises NotImplementedError naming it;
    the forward and gradients elsewhere still run."""
    rng = np.random.default_rng(306)
    x = torch.tensor(rng.random(8), requires_grad=True)
    y = torch.tensor(rng.random(8), requires_grad=True)
    idx = vt.vector(data=np.arange(8)[::-1].copy(), context=tctx)
    c = vt.vector(data=rng.random(8), context=tctx)

    fn = _function(tgen, vt, lambda m, u, v: m.nextafter(u, 0.5) + v, 2)
    with pytest.raises(NotImplementedError, match="nextafter"):
        torch.autograd.grad(fn(x, y)[0].sum(), x)
    (gy,) = torch.autograd.grad(fn(x.detach(), y)[0].sum(), y)
    assert torch.equal(gy, torch.ones(8, dtype=torch.float64))

    # a view and a reduction read their operand through a vector leaf,
    # which gives them their size
    fn = _function(tgen, vt, lambda m, u: m.permutation(idx)(u + c) * 2.0,
                   1)
    with pytest.raises(NotImplementedError, match="PermutationView"):
        torch.autograd.grad(fn(x)[0].sum(), x)
    with torch.no_grad():
        assert torch.equal(fn(x)[0], (x + c.storage).flip(0) * 2.0)

    fn = _function(tgen, vt, lambda m, u: m.reduce_view(
        "sum", m.reshape(u + c, (8, 1)), 1) + u, 1)
    with pytest.raises(NotImplementedError, match="ReducedView"):
        torch.autograd.grad(fn(x)[0].sum(), x)


def _backward_source(kernel, arrays, cots, needs):
    """The backward kernel's trees, bound and prepared, and the source of
    its K1 kernel."""
    from vexcl_tpu_torch.expr.triton_emit import assign_multi_source
    from vexcl_tpu_torch.types import code_of

    bk = kernel.backward_kernel(arrays, cots, needs)
    exprs, analysis, types, _ = bk.prepare_function(
        *arrays, *[c for c in cots if c is not None])
    src = assign_multi_source(exprs, analysis, types,
                              [code_of(a.dtype) for a, need
                               in zip(arrays, needs) if need])
    return exprs, src


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_lorenz_backward_source_defines_each_node_once(tctx, dt):
    """The Lorenz step's backward kernel reads x, y, z, R and the three
    cotangents once, writes four gradients, and defines each node of its
    DAG once: the forward nodes it recomputes are shared by the four
    adjoint trees, as the RK4 stages are by the three outputs."""
    import re

    m = LorenzEnsemble(64, dtype=dt, context=tctx)
    arrays = [v.storage for v in (m.x, m.y, m.z, m.R)]
    cots = [torch.ones_like(a) for a in arrays[:3]]
    exprs, src = _backward_source(m._step, arrays, cots, [True] * 4)
    compile(src, "<backward>", "exec")
    nodes, stack = {}, list(exprs)
    while stack:
        e = stack.pop()
        if id(e) not in nodes:
            nodes[id(e)] = e
            stack.extend(e.children)
    defs = re.findall(r"^    ([txv]\d+) = ", src, re.MULTILINE)
    assert len(defs) == len(set(defs)) == len(nodes)
    assert src.count("tl.load(") == 7 and src.count("tl.store(") == 4


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_backward_sources_parse(tctx, dt):
    """The backward kernel of every differentiable builtin, and the
    saturating casts of every float type into every integer type, give
    kernel sources that parse (the card compiles and runs them)."""
    from vexcl_tpu_torch.expr.compile import prepare_multi
    from vexcl_tpu_torch.expr.triton_emit import assign_multi_source

    rng = np.random.default_rng(307)
    for name in DIFFERENTIABLE:
        args = [torch.from_numpy(a) for a in _operands(name, dt, rng, 64)]
        kernel = _kernel(tgen, vt, lambda m, *p: m.BUILTINS[name](*p),
                         len(args))
        cot = torch.ones(64, dtype=args[0].dtype)
        _, src = _backward_source(kernel, args, [cot],
                                  [a.is_floating_point() for a in args])
        compile(src, f"<{name}>", "exec")
    ints = ["i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64"]
    for src_t in (torch.float16, torch.bfloat16, torch.float32,
                  torch.float64, torch.complex128):
        x = vt.vector(data=torch.zeros(64, dtype=src_t), context=tctx)
        e, an, ty, _ = prepare_multi(
            [vt.cast(vt.types.dtype_of_code(c), x) for c in ints], 64,
            tctx.device)
        compile(assign_multi_source(e, an, ty, ints), "<casts>", "exec")


def test_functional_calls_keep_a_record_per_binding(tctx):
    """``as_function`` keeps its analysis per binding (types, shapes and
    devices of the arguments), as a recorded kernel's call does: strided
    arguments (a stride-0 cotangent, a slice) take the record of the
    contiguous ones and give the same values."""
    kernel = _kernel(tgen, vt, lambda m, u, v: m.sin(u) * v, 2)
    fn = kernel.as_function()
    x = torch.rand(16, dtype=torch.float64)
    ones = torch.ones(16, dtype=torch.float64)
    for v in (ones, torch.ones(1, dtype=torch.float64).expand(16),
              torch.arange(32.0, dtype=torch.float64)[::2]):
        for _ in range(2):
            (y,) = fn(x, v)
            assert torch.equal(y, torch.sin(x) * v)
    assert len(kernel._bindings) == 1
    assert next(iter(kernel._bindings.values())) is not None


def test_gradient_steps_analyse_no_tree_after_the_first(monkeypatch, tctx):
    """After a first gradient through 3 Lorenz steps (the last step's
    cotangents the stride-0 gradient of a sum), later gradients look up
    the records of the forward and backward calls: no tree is analysed
    anew, and the gradients are the first one's."""
    m = LorenzEnsemble(64, dtype=np.float64, context=tctx)
    fn = m._step.as_function()
    ins = [v.storage.clone().requires_grad_()
           for v in (m.x, m.y, m.z, m.R)]

    def gradient():
        x, y, z, R = ins
        for _ in range(3):
            x, y, z = fn(x, y, z, R)
        return torch.autograd.grad((x + y + z).sum(), ins)

    first = gradient()
    calls = []
    record, prepare_multi = tgen.Kernel._record, tgen.prepare_multi

    def counted(name, f):
        def call(*args, **kwargs):
            calls.append(name)
            return f(*args, **kwargs)
        return call

    monkeypatch.setattr(tgen.Kernel, "_record", counted("_record", record))
    monkeypatch.setattr(tgen, "prepare_multi",
                        counted("prepare_multi", prepare_multi))
    for _ in range(2):
        again = gradient()
        assert calls == []
        for g, f in zip(again, first):
            assert torch.equal(g, f)


def test_gradient_over_no_elements(tctx):
    """Over an empty vector the backward launches nothing: an empty
    gradient for the vector, and for the 0-d tensor the sum of no
    elements, zero."""
    kernel = _kernel(tgen, vt, lambda m, u, v: m.sin(u) * v, 2)
    x = torch.zeros(0, dtype=torch.float64, requires_grad=True)
    a = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    (y,) = kernel.as_function()(x, a)
    gx, ga = torch.autograd.grad(y.sum(), (x, a))
    assert gx.shape == (0,) and ga.shape == () and float(ga) == 0.0
