#!/usr/bin/env python
"""A Lorenz-attractor parameter sweep through the symbolic kernel
generator (examples/symbolic_odeint.py's counterpart), through the
PyTorch/CUDA port::

    python examples/torch/symbolic_odeint.py            # the cards
    python examples/torch/symbolic_odeint.py --device cpu --n 256 --steps 10

A generic Python RK4 stepper runs once over symbolic state; the recorded
trees become one fused kernel (K1 on the card) applied to the whole
ensemble a step.  Its first step is held against the same RK4 in numpy
f64.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name, ms_per_call  # noqa: E402
from vexcl_tpu_torch import generator  # noqa: E402

SIGMA, B = 10.0, 8.0 / 3.0
DT = 0.01


def lorenz(state, R):
    x, y, z = state
    return (SIGMA * (y - x), R * x - y - x * z, x * y - B * z)


def rk4_step(sys_fn, state, R, dt):
    """Generic RK4 over any state type: numpy arrays or symbolics."""
    k1 = sys_fn(state, R)
    s2 = tuple(s + 0.5 * dt * k for s, k in zip(state, k1))
    k2 = sys_fn(s2, R)
    s3 = tuple(s + 0.5 * dt * k for s, k in zip(state, k2))
    k3 = sys_fn(s3, R)
    s4 = tuple(s + dt * k for s, k in zip(state, k3))
    k4 = sys_fn(s4, R)
    return tuple(s + dt / 6.0 * (a + 2 * b + 2 * c + d)
                 for s, a, b, c, d in zip(state, k1, k2, k3, k4))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--n", type=int, default=1 << 14,
                    help="the ensemble's size")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)

    sx, sy, sz, sR = (generator.symbolic() for _ in range(4))
    nx, ny, nz = rk4_step(lorenz, (sx, sy, sz), sR, DT)
    sx.assign(nx)
    sy.assign(ny)
    sz.assign(nz)
    step = generator.build_kernel("lorenz_rk4", [sx, sy, sz],
                                  params=[sx, sy, sz, sR])

    n = args.n
    rng = np.random.default_rng(0)
    h = [(rng.random(n) * 10).astype(np.float32) for _ in range(3)]
    hR = np.linspace(0.1, 50, n).astype(np.float32)
    X, Y, Z = (vex.vector(data=v, context=ctx) for v in h)
    R = vex.vector(data=hR, context=ctx)

    # one step against the same RK4 in numpy f64 (the system is chaotic:
    # f32 and f64 drift apart over many steps)
    step(X, Y, Z, R)
    want = np.stack(rk4_step(lorenz, tuple(v.astype(np.float64) for v in h),
                             hR.astype(np.float64), DT))
    got = np.stack([v.to_numpy() for v in (X, Y, Z)])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    print(f"check one RK4 step against numpy f64: ok (rel err {err:.1e})")

    def run():
        for _ in range(args.steps):
            step(X, Y, Z, R)
        return X

    ms = ms_per_call(run, ctx, 1)
    stats = vex.Reductor(vex.MIN_MAX, context=ctx)(X)
    print(f"{args.steps} RK4 steps x {n} ensemble members: {ms:.3f} ms "
          f"({args.steps * n / ms / 1e3:.1f} M steps/s) on "
          f"{device_name(ctx)}")
    print(f"final x range: [{float(stats[0]):.3f}, {float(stats[1]):.3f}]")


if __name__ == "__main__":
    main()
