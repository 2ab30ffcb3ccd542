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
    the backward does not have (the SpMV's transposed product, a
    stencil's, the FFT's inverse, an image's scatter of its taps), a
    gradient asked through the node raises NotImplementedError naming it;
    the forward and gradients elsewhere still run."""
    import scipy.sparse as sp

    rng = np.random.default_rng(306)
    x = torch.tensor(rng.random(8), requires_grad=True)
    y = torch.tensor(rng.random(8), requires_grad=True)
    c = vt.vector(data=rng.random(8), context=tctx)

    fn = _function(tgen, vt, lambda m, u, v: m.nextafter(u, 0.5) + v, 2)
    with pytest.raises(NotImplementedError, match="nextafter"):
        torch.autograd.grad(fn(x, y)[0].sum(), x)
    (gy,) = torch.autograd.grad(fn(x.detach(), y)[0].sum(), y)
    assert torch.equal(gy, torch.ones(8, dtype=torch.float64))

    # the SpMV and a stencil read their operand through a vector leaf,
    # which gives them their size
    a = sp.random(8, 8, density=0.4, random_state=1, format="csr") \
        + sp.eye(8, format="csr")
    mat = vt.SpMat(8, 8, a.indptr, a.indices, a.data, context=tctx)
    fn = _function(tgen, vt, lambda m, u: mat * (u + c) + u, 1)
    with pytest.raises(NotImplementedError, match="SpMVExpr"):
        torch.autograd.grad(fn(x)[0].sum(), x)
    with torch.no_grad():
        assert torch.allclose(fn(x)[0], torch.from_numpy(
            a @ (x.numpy() + c.to_numpy())) + x, rtol=1e-12)

    st = vt.stencil([1.0, -2.0, 1.0], 1, context=tctx)
    fn = _function(tgen, vt, lambda m, u: st * (u + c) * u, 1)
    with pytest.raises(NotImplementedError, match="StencilExpr"):
        torch.autograd.grad(fn(x)[0].sum(), x)

    # the FFT (a complex value) and an image sample (a view of its own)
    fn = _function(tgen, vt, lambda m, u: m.FFT(8)(u + c), 1)
    with pytest.raises(NotImplementedError, match="FFTExpr"):
        torch.autograd.grad(fn(x)[0].real.sum(), x)
    img = vt.image2d(rng.random((4, 4)), filter="linear", context=tctx)
    fn = _function(tgen, vt, lambda m, u: img(u * 3.0, c * 3.0), 1)
    with pytest.raises(NotImplementedError, match="ImageSample"):
        torch.autograd.grad(fn(x)[0].sum(), x)


# -- views and partial reductions: gradients and vmap ----------------------

#: a permutation's index over 8 elements: a duplicate (7, 7), a negative
#: key that wraps onto it (-1), keys beyond the end (9, 12, and -9, which
#: wraps to -1): read as NaN, dropped by the scatter
PERM = np.array([3, 1, 0, 7, 7, 2, -1, 9, 5, 5, 12, -9], np.int32)
#: an index-array key: a duplicate and a negative key that wraps onto
#: another (a key beyond the end: ``test_clamped_key_gradient``)
KEY = np.array([2, 2, -1, 7, 0], np.int64)
#: a 2 x 4 operand with ties along both axes (min and max)
TIES = np.array([1.0, 3.0, 3.0, 0.5, 1.0, 3.0, 2.0, 2.0])
#: a 2 x 4 operand with zeros: row 0 and column 2 hold one, row 1 and
#: column 0 two (prod)
ZEROS = np.array([0.0, 3.0, 2.0, 0.5, 0.0, 1.5, 0.0, 1.25])


def _view_module(m):
    import importlib

    return importlib.import_module(m.__name__ + ".expr.view")


#: name -> (body(m, vec, u), the operand u): each view class over an
#: expression of the parameter u (8 elements) and a vector c
VIEWS = {
    "permutation": (lambda m, vec, u: m.permutation(vec(PERM))(
        u + vec("c")) * 2.0, None),
    "pointer": (lambda m, vec, u: m.raw_pointer(u * u + vec("c"))[
        vec(PERM)], None),
    # a bare parameter as the operand: its length comes with the call
    "permutation_of_parameter": (lambda m, vec, u: m.permutation(
        vec(PERM))(u), None),
    "pointer_to_parameter": (lambda m, vec, u: m.raw_pointer(u)[
        vec(PERM)] * 2.0, None),
    "slice": (lambda m, vec, u: _view_module(m).SliceTerminal(
        u * u + vec("c"), slice(1, 7, 2)), None),
    "slice_index_array": (lambda m, vec, u: _view_module(m).SliceTerminal(
        u * u + vec("c"), KEY) * 3.0, None),
    "slicer": (lambda m, vec, u: m.slicer([2, 4])[:, 1:3](u + vec("c")),
               None),
    "slicer_negative_steps": (lambda m, vec, u: m.slicer([2, 4])[
        ::-1, 3:0:-2](u * u + vec("c")), None),
    "slicer_index_array": (lambda m, vec, u: m.slicer([2, 4])[
        :, np.array([3, 0, 3])](u * u + vec("c")), None),
    "slicer_one_element": (lambda m, vec, u: m.slicer([2, 4])[1, 2](
        u * u + vec("c")) * u, None),
    "reshape_transpose": (lambda m, vec, u: m.reshape(
        u * u + vec("c"), (4, 2), (1, 0)), None),
    "reshape_broadcast": (lambda m, vec, u: m.reshape(
        u * u + vec("c"), (3, 8), (1,)), None),
    **{f"reduce_{op}_axis{axis}": (
        lambda m, vec, u, op=op, axis=axis: m.reduce_view(
            op, m.slicer([2, 4])[:, :](u * vec("one")), axis),
        {"sum": None, "min": TIES, "max": TIES, "prod": ZEROS}[op])
       for op in ("sum", "min", "max", "prod") for axis in (0, 1)},
}


def _vectors(m, dt, ctx1, tctx, seed):
    """``vec(h)``: a vector of h in package m (c and one by name)."""
    named = {"c": np.random.default_rng(seed).random(8).astype(dt),
             "one": np.ones(8, dt)}

    def vec(h):
        h = named.get(h) if isinstance(h, str) else h
        if m is vex:
            return vex.vector(data=h, context=ctx1)
        return vt.vector(data=h, context=tctx)

    return vec


def _view_function(gen, m, body, dt, ctx1, tctx, nargs=1, seed=310):
    vec = _vectors(m, dt, ctx1, tctx, seed)
    return _function(gen, m, lambda m_, *p: body(m_, vec, *p), nargs)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(VIEWS))
def test_view_gradient_matches_jax(ctx1, tctx, case, dt):
    """The gradient of sum(w f(u)) through each view class and every
    reduce_view op on axes 0 and 1 against jax.grad of vexcl_tpu's
    kernel: duplicate, wrapped, clamped and dropped keys, ties of min and
    max (split equally), prod rows and columns with one zero and two."""
    body, hu = VIEWS[case]
    rng = np.random.default_rng(311)
    hu = (rng.uniform(0.5, 1.5, 8) if hu is None else hu).astype(dt)
    jf = _view_function(jgen, vex, body, dt, ctx1, tctx)
    tf = _view_function(tgen, vt, body, dt, ctx1, tctx)
    with torch.no_grad():
        n = tf(torch.from_numpy(hu))[0].numel()
    w = rng.uniform(0.5, 1.5, n).astype(dt)
    import jax
    import jax.numpy as jnp

    (want,) = [jax.grad(lambda u: jnp.sum(jnp.asarray(w) * jnp.ravel(
        jf(u)[0])))(jnp.asarray(hu))]
    u = torch.tensor(hu, requires_grad=True)
    (out,) = tf(u)
    np.testing.assert_array_equal(np.isnan(out.detach().numpy()),
                                  np.isnan(np.ravel(jf(jnp.asarray(hu))[0])))
    (got,) = torch.autograd.grad(
        torch.nansum(torch.from_numpy(w) * out), u)
    assert got.dtype == vt.dtype_of(dt) and got.shape == (8,)
    _close(got.numpy(), want, TOL[dt])
    # the same through torch.func.grad
    got = torch.func.grad(lambda t: torch.nansum(
        torch.from_numpy(w) * tf(t)[0]))(torch.from_numpy(hu))
    _close(got.numpy(), want, TOL[dt])


def test_clamped_key_gradient(ctx1, tctx):
    """An index-array key beyond the end reads the last element (numpy's
    advanced indexing, clamped, in both packages), and its cotangent goes
    where it read: the port's scatter follows its forward.  JAX's
    gradient of the clamped gather drops it instead (its scatter drops
    what lies out of bounds), so the gradients differ there and only
    there."""
    import jax
    import jax.numpy as jnp

    key = np.array([2, 2, -1, 9, 0])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    hu = np.random.default_rng(316).random(8)

    def body(m, vec, u):
        return _view_module(m).SliceTerminal(u * u + vec("c"), key)

    jf = _view_function(jgen, vex, body, np.float64, ctx1, tctx)
    tf = _view_function(tgen, vt, body, np.float64, ctx1, tctx)
    u = torch.tensor(hu, requires_grad=True)
    (out,) = tf(u)
    _close(out.detach().numpy(), jf(jnp.asarray(hu))[0], 1e-12)
    (got,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), u)
    want = np.zeros(8)
    np.add.at(want, [2, 2, 7, 7, 0], w * 2 * hu[[2, 2, 7, 7, 0]])
    _close(got.numpy(), want, 1e-12)
    jax_g = np.asarray(jax.grad(lambda t: jnp.sum(
        jnp.asarray(w) * jf(t)[0]))(jnp.asarray(hu)))
    _close(np.delete(got.numpy(), 7), np.delete(jax_g, 7), 1e-12)
    assert abs(got[7].item() - jax_g[7] - 4.0 * 2 * hu[7]) < 1e-12


def test_zero_d_argument_beneath_a_view(ctx1, tctx):
    """A 0-d a read beneath a permutation sums its adjoint over the
    operand's 8 elements, not the view's 12; read beneath it and beside
    it, it is read over two lengths and raises, naming itself."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(312)
    hu, w = rng.random(8), rng.random(len(PERM))

    def body(m, vec, u, a):
        return m.permutation(vec(PERM))(u * a + vec("c"))

    jf = _view_function(jgen, vex, body, np.float64, ctx1, tctx, 2)
    tf = _view_function(tgen, vt, body, np.float64, ctx1, tctx, 2)
    wu, wa = jax.grad(lambda u, a: jnp.nansum(jnp.asarray(w) * jf(u, a)[0]),
                      argnums=(0, 1))(jnp.asarray(hu), jnp.asarray(1.7))
    u = torch.tensor(hu, requires_grad=True)
    a = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    gu, ga = torch.autograd.grad(
        torch.nansum(torch.from_numpy(w) * tf(u, a)[0]), (u, a))
    assert ga.shape == ()
    _close(gu.numpy(), wu, 1e-10)
    _close(ga.numpy(), wa, 1e-10)

    fn = _view_function(tgen, vt, lambda m, vec, u, a: body(m, vec, u, a) * a,
                        np.float64, ctx1, tctx, 2)
    with pytest.raises(NotImplementedError, match="read over"):
        torch.autograd.grad(fn(u, a)[0].nansum(), (u, a))


@pytest.mark.parametrize("case", ["permutation", "reduce_sum_axis1"])
def test_second_order_through_a_view_raises(ctx1, tctx, case):
    """A second derivative through a view's scatter raises, naming the
    view; the first derivative with create_graph=True still runs."""
    body, _ = VIEWS[case]
    tf = _view_function(tgen, vt, body, np.float64, ctx1, tctx)
    u = torch.rand(8, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch.nansum(tf(u)[0] ** 2), u,
                               create_graph=True)
    name = "PermutationView" if case == "permutation" else "MultiSliceView"
    with pytest.raises(NotImplementedError, match=name):
        torch.autograd.grad((g * g).sum(), u)


@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
def test_second_order_through_reduce_view_matches_jax(ctx1, tctx, op):
    """A second derivative through reduce_view of a 1-D expression (its
    backward spreads the cotangent without a scatter) against
    jax.grad(jax.grad(...))."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(317)
    hu = rng.uniform(0.5, 1.5, 8)

    def body(m, vec, u):
        return m.reduce_view(op, u * u + vec("c"), 0)

    jf = _view_function(jgen, vex, body, np.float64, ctx1, tctx)
    tf = _view_function(tgen, vt, body, np.float64, ctx1, tctx)
    want = jax.grad(lambda t: jnp.sum(jax.grad(
        lambda v: jnp.sum(jf(v)[0]))(t) ** 2))(jnp.asarray(hu))
    u = torch.tensor(hu, requires_grad=True)
    (g,) = torch.autograd.grad(tf(u)[0].sum(), u, create_graph=True)
    (got,) = torch.autograd.grad((g * g).sum(), u)
    _close(got.numpy(), want, 1e-10)


#: view classes and reductions for vmap: body(m, vec, u, v)
VMAPS = {
    "permutation": lambda m, vec, u, v: m.permutation(vec(PERM))(
        u * v + vec("c")),
    "pointer": lambda m, vec, u, v: m.raw_pointer(u * v + vec("c"))[
        vec(PERM)],
    "slice": lambda m, vec, u, v: _view_module(m).SliceTerminal(
        u * v + vec("c"), slice(1, 7, 2)),
    "slicer": lambda m, vec, u, v: m.slicer([2, 4])[:, 1:3](u * v + vec("c")),
    "reshape": lambda m, vec, u, v: m.reshape(u * v + vec("c"), (4, 2),
                                              (1, 0)),
    "reduce_sum": lambda m, vec, u, v: m.reduce_view(
        "sum", m.slicer([2, 4])[:, :](u * v + vec("c")), 1),
    "reduce_max": lambda m, vec, u, v: m.reduce_view(
        "max", m.slicer([2, 4])[:, :](u * v + vec("c")), 0),
}


@pytest.mark.parametrize("case", sorted(VMAPS))
def test_vmap_through_views_matches_jax(ctx1, tctx, case):
    """torch.func.vmap through a kernel that holds a view or a
    reduce_view, u batched on axis 1 and v unbatched, then both batched
    on axis 0, against jax.vmap: one call a batch element."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(313)
    hu, hv, hb = rng.random((8, 3)), rng.random(8), rng.random((3, 8))
    jf = _view_function(jgen, vex, VMAPS[case], np.float64, ctx1, tctx, 2)
    tf = _view_function(tgen, vt, VMAPS[case], np.float64, ctx1, tctx, 2)
    want = jax.vmap(lambda u: jnp.ravel(jf(u, jnp.asarray(hv))[0]),
                    in_axes=1)(jnp.asarray(hu))
    got = torch.func.vmap(lambda u: tf(u, torch.from_numpy(hv))[0],
                          in_dims=1)(torch.from_numpy(hu))
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-12)
    want = jax.vmap(lambda u, v: jnp.ravel(jf(u, v)[0]))(
        jnp.asarray(hb), jnp.asarray(hb[::-1].copy()))
    got = torch.func.vmap(lambda u, v: tf(u, v)[0])(
        torch.from_numpy(hb), torch.from_numpy(hb[::-1].copy()))
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("case", ["permutation", "reduce_max", "slicer"])
def test_vmap_of_gradients_through_views_matches_jax(ctx1, tctx, case):
    """torch.func.vmap of torch.func.grad through a view, in u (a batch
    of 3) and in a 0-d v of each batch element (its gradient a sum per
    batch element), against jax.vmap of jax.grad."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(314)
    hu, hv = rng.random((3, 8)), rng.random(3)
    jf = _view_function(jgen, vex, VMAPS[case], np.float64, ctx1, tctx, 2)
    tf = _view_function(tgen, vt, VMAPS[case], np.float64, ctx1, tctx, 2)
    want = jax.vmap(jax.grad(lambda u, v: jnp.nansum(jf(u, v)[0] ** 2),
                             argnums=(0, 1)))(jnp.asarray(hu),
                                              jnp.asarray(hv))
    got = torch.func.vmap(torch.func.grad(
        lambda u, v: torch.nansum(tf(u, v)[0] ** 2), argnums=(0, 1)))(
        torch.from_numpy(hu), torch.from_numpy(hv))
    for g, v in zip(got, want):
        assert g.shape == v.shape
        _close(g.numpy(), v, 1e-10)


def test_vmap_of_a_gradient_of_a_0d_argument(tctx):
    """vmap of the gradient in a 0-d a of an elementwise tree: a sum per
    batch element (the backward kernel runs once a batch element), as
    jax.vmap(jax.grad(...)) gives."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(315)
    hx, ha = rng.random((4, 16)), rng.random(4)

    def body(m, x, a):
        return m.sin(x) * a + x * x

    jf, tf = _function(jgen, vex, body, 2), _function(tgen, vt, body, 2)
    want = jax.vmap(jax.grad(lambda x, a: jnp.sum(jf(x, a)[0] ** 2),
                             argnums=(0, 1)))(jnp.asarray(hx),
                                              jnp.asarray(ha))
    got = torch.func.vmap(torch.func.grad(
        lambda x, a: (tf(x, a)[0] ** 2).sum(), argnums=(0, 1)))(
        torch.from_numpy(hx), torch.from_numpy(ha))
    for g, v in zip(got, want):
        assert g.shape == v.shape
        _close(g.numpy(), v, 1e-10)


@pytest.mark.parametrize("axis", [0, 1])
def test_vmap_of_an_elementwise_gradient_folds(tctx, axis):
    """vmap of the gradient in a vector x of an elementwise tree, beside
    an unbatched vector a: the backward kernel folds the batch into the
    elements (its gradient as long as the folded x), as
    jax.vmap(jax.grad(...)) gives."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(316)
    hx, ha = rng.random((4, 16)), rng.random(16)
    hx = hx if axis == 0 else hx.T.copy()

    def body(m, x, a):
        return m.sin(x) * a + x * x

    jf, tf = _function(jgen, vex, body, 2), _function(tgen, vt, body, 2)
    want = jax.vmap(jax.grad(lambda x, a: jnp.sum(jf(x, a)[0] ** 2)),
                    in_axes=(axis, None))(jnp.asarray(hx), jnp.asarray(ha))
    got = torch.func.vmap(torch.func.grad(
        lambda x, a: (tf(x, a)[0] ** 2).sum()), in_dims=(axis, None))(
        torch.from_numpy(hx), torch.from_numpy(ha))
    assert got.shape == want.shape == (4, 16)
    _close(got.numpy(), want, 1e-10)


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
