"""Parity of the port's symbolic generator, user functions and the Lorenz
RK4 ensemble with vexcl_tpu.

The same numpy inputs (from a seed) go through both packages on the CPU,
where a recorded kernel runs the plain version of the k-output
assignment kernel.  The Lorenz ensemble of the port starts from the JAX
model's own state (``LorenzEnsemble.from_arrays``) and both step it 10
times.  The generated kernel source of the Lorenz step is checked to
define each node of the step's DAG once (the RK4 stages are shared by the
three outputs; as a tree the body would be many times larger).

Tolerances, relative to the largest magnitude: f64 1e-12, f32 1e-5 (the
packages' f32 arithmetic may round differently; 10 steps of a chaotic
system).
"""

import math
import re

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu import generator as jgen
from vexcl_tpu.models import LorenzEnsemble as JLorenz
from vexcl_tpu_torch import generator as tgen
from vexcl_tpu_torch.expr.triton_emit import assign_multi_source, kernel_key
from vexcl_tpu_torch.models import LorenzEnsemble
from vexcl_tpu_torch.types import code_of

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _euler4(gen, dt):
    x = gen.symbolic()
    for _ in range(4):
        x.assign(x - dt * x)
    return gen.build_kernel("euler4", [x], params=[x])


def test_symbolic_euler(ctx1, tctx):
    rng = np.random.default_rng(101)
    hx = rng.random(1024)
    jX = vex.vector(data=hx, context=ctx1)
    tX = vt.vector(data=hx, context=tctx)
    jstep, tstep = _euler4(jgen, 0.01), _euler4(tgen, 0.01)
    for _ in range(2):              # the kernel is reusable
        jstep(jX)
        tstep(tX)
    _close(tX.to_numpy(), np.asarray(jX), 1e-12)
    with pytest.raises(ValueError):
        tstep(tX, tX)


def _lorenz(x, y, z, R, sigma=10.0, b=8.0 / 3.0):
    return (sigma * (y - x), R * x - y - x * z, x * y - b * z)


def _rk4(x, y, z, R, dt=0.01):
    k1 = _lorenz(x, y, z, R)
    k2 = _lorenz(x + 0.5 * dt * k1[0], y + 0.5 * dt * k1[1],
                 z + 0.5 * dt * k1[2], R)
    k3 = _lorenz(x + 0.5 * dt * k2[0], y + 0.5 * dt * k2[1],
                 z + 0.5 * dt * k2[2], R)
    k4 = _lorenz(x + dt * k3[0], y + dt * k3[1], z + dt * k3[2], R)
    return tuple(s + dt / 6 * (a + 2 * b + 2 * c + d) for s, a, b, c, d in
                 zip((x, y, z), k1, k2, k3, k4))


def _rk4_kernel(gen):
    sx, sy, sz, sR = (gen.symbolic() for _ in range(4))
    for s, v in zip((sx, sy, sz), _rk4(sx, sy, sz, sR)):
        s.assign(v)
    return gen.build_kernel("lorenz_rk4", [sx, sy, sz],
                            params=[sx, sy, sz, sR])


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_rk4_lorenz_through_build_kernel(ctx1, tctx, dt):
    rng = np.random.default_rng(102)
    n = 256
    hs = [rng.random(n).astype(dt) for _ in range(3)]
    hs.append(np.linspace(10, 30, n).astype(dt))
    jv = [vex.vector(data=h, context=ctx1) for h in hs]
    tv = [vt.vector(data=h, context=tctx) for h in hs]
    _rk4_kernel(jgen)(*jv)
    _rk4_kernel(tgen)(*tv)
    for j, t in zip(jv[:3], tv[:3]):
        assert t.dtype == vt.dtype_of(dt)      # weak constants keep f32
        _close(t.to_numpy(), np.asarray(j), RTOL[dt])


def test_make_function(ctx1, tctx):
    rng = np.random.default_rng(103)
    hx = rng.random(512)
    jf = jgen.make_function(lambda a, b: a * a + b)
    tf = tgen.make_function(lambda a, b: a * a + b)
    jy = vex.vector(512, dtype=np.float64, context=ctx1)
    ty = vt.vector(512, dtype=np.float64, context=tctx)
    jy[:] = jf(vex.vector(data=hx, context=ctx1), 1.0)
    ty[:] = tf(vt.vector(data=hx, context=tctx), 1.0)
    _close(ty.to_numpy(), np.asarray(jy), 1e-12)


def test_function_and_Function(ctx1, tctx):
    rng = np.random.default_rng(104)
    hx, hy = rng.random(512), rng.random(512)

    def body(m):
        @m.function
        def squared_radius(x, y):
            return x * x + y * y

        # functions calling functions need no declaration
        rad = m.Function("rad", lambda x, y: m.sqrt(squared_radius(x, y)))
        return squared_radius, rad

    outs = []
    for m, c in ((vex, ctx1), (vt, tctx)):
        sq, rad = body(m)
        assert sq(3.0, 4.0) == 25          # eager on plain numbers
        x, y = (m.vector(data=h, context=c) for h in (hx, hy))
        z = m.vector(512, dtype=np.float64, context=c)
        z[:] = rad(x, y) + sq(x, 2.0)
        outs.append(np.asarray(z.to_numpy() if m is vt else z))
        mv = m.multivector(data=np.stack([hx, hy]), context=c)
        w = m.multivector(512, 2, dtype=np.float64, context=c)
        w[:] = sq(mv, 1.0)                  # componentwise
        outs.append(w.to_numpy())
    _close(outs[2], outs[0], 1e-12)
    _close(outs[3], outs[1], 1e-12)
    t = vt.function(name="plain")(lambda x: x + 1)
    assert torch.equal(t(torch.arange(3.0)), torch.arange(1.0, 4.0))
    bad = vt.Function("bad", lambda x: math.sin(x))
    with pytest.raises(TypeError, match="bad"):
        bad(vt.vector(data=hx, context=tctx))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_lorenz_ensemble_from_the_jax_state(ctx1, tctx, dt):
    jm = JLorenz(256, dtype=dt, context=ctx1, seed=3)
    tm = LorenzEnsemble.from_arrays(*jm.state(), np.asarray(jm.R.array),
                                    context=tctx)
    seeded = LorenzEnsemble(256, dtype=dt, context=tctx, seed=3)
    for a, b in zip(seeded.state(), jm.state()):
        np.testing.assert_array_equal(a, b)     # the same seeded state
    jm.step(10)
    tm.step(10)
    for t, j in zip(tm.state(), jm.state()):
        assert t.dtype == j.dtype == dt
        _close(t, j, RTOL[dt])


def test_lorenz_source_defines_each_node_once(tctx):
    m = LorenzEnsemble(64, context=tctx)
    exprs, analysis, types, _, outs = m._step.prepare(m.x, m.y, m.z, m.R)
    nodes, stack = {}, list(exprs)
    while stack:
        e = stack.pop()
        if id(e) not in nodes:
            nodes[id(e)] = e
            stack.extend(e.children)
    src = assign_multi_source(exprs, analysis, types,
                              [code_of(o.dtype) for o in outs])
    defs = re.findall(r"^    ([txv]\d+) = ", src, re.MULTILINE)
    assert len(defs) == len(set(defs)) == len(nodes)
    assert src.count("tl.load(") == 4 and src.count("tl.store(") == 3
    # the signature is the tree's, not the bound tensors': another
    # ensemble of the same type hits the same kernel
    m2 = LorenzEnsemble(128, context=tctx, seed=1)
    analysis2 = m2._step.prepare(m2.x, m2.y, m2.z, m2.R)[1]
    assert kernel_key(analysis, None) == kernel_key(analysis2, None)


def test_kernel_as_function(ctx1, tctx):
    """The functional form chains as the steps do, and differentiates: the
    gradient of sum(x_T) after 3 steps in (x0, R), against jax.grad of
    vexcl_tpu's kernel from the same state."""
    import jax
    import jax.numpy as jnp

    jm = JLorenz(64, dtype=np.float64, context=ctx1)
    state = [np.array(np.asarray(v)) for v in (*jm.state(), jm.R)]
    m = LorenzEnsemble.from_arrays(*state, context=tctx)
    x, y, z, R = (v.storage.clone() for v in (m.x, m.y, m.z, m.R))
    fn = m._step.as_function()
    for _ in range(3):
        x, y, z = fn(x, y, z, R)
    m.step(3)
    for a, v in zip((x, y, z), (m.x, m.y, m.z)):
        assert torch.equal(a, v.storage)
    jfn = jm._step.as_function()

    def loss(x, y, z, R):
        for _ in range(3):
            x, y, z = jfn(x, y, z, R)
        return jnp.sum(x)

    want = jax.grad(loss, argnums=(0, 3))(*map(jnp.asarray, state))
    ts = [torch.tensor(s, requires_grad=i in (0, 3))
          for i, s in enumerate(state)]
    x, y, z, R = ts
    for _ in range(3):
        x, y, z = fn(x, y, z, R)
    got = torch.autograd.grad(x.sum(), (ts[0], ts[3]))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-10)
