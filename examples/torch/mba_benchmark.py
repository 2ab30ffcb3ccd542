#!/usr/bin/env python
"""MBA scattered interpolation (examples/mba_benchmark.py's counterpart),
through the PyTorch/CUDA port: fit a multilevel B-spline to scattered
2-D samples of a test function on the host, then time its evaluation at
N query points inside an expression::

    python examples/torch/mba_benchmark.py              # the cards, 2^20
    python examples/torch/mba_benchmark.py --device cpu --log2 10 \\
        --samples 256

On the card ``out[:] = 2 * surf(qx, qy) + 1`` is one launch of the MBA
kernel (``csrc/mba.cu``) and one of the expression around it; the
result is held against the surface's own f64 host evaluation.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name, ms_per_call  # noqa: E402


def f(x, y):
    return (np.sin(7 * x) * np.cos(5 * y)
            + 0.3 * np.exp(-8 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--log2", type=int, default=20,
                    help="the number of query points, a power of two")
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)
    n = 1 << args.log2
    rng = np.random.default_rng(0)
    sx, sy = rng.random(args.samples), rng.random(args.samples)

    t = time.perf_counter()
    surf = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                   values=f(sx, sy), grid=(8, 8), levels=7, context=ctx)
    fit_ms = (time.perf_counter() - t) * 1e3
    print(f"fit: {len(surf.fit_grids)} levels flattened onto "
          f"{surf.grids[0]}, residual {surf.residual:.2e}, "
          f"{fit_ms:.1f} ms (host)")

    hx, hy = rng.random(n), rng.random(n)
    qx = vex.vector(data=hx, context=ctx)
    qy = vex.vector(data=hy, context=ctx)
    out = vex.vector(n, dtype=np.float64, context=ctx)

    def run():
        out[:] = 2.0 * surf(qx, qy) + 1.0
        return out

    ms = ms_per_call(run, ctx, args.reps)
    print(f"eval: {n} points in {ms:.4f} ms -> {n / ms / 1e3:.1f} "
          f"Mpoints/s on {device_name(ctx)}")
    got = out.to_numpy()
    k = min(n, 4096)        # the host evaluation of the first k points
    host = vex.vector(k, dtype=np.float64, context=vex.Context(
        device="cpu", set_current=False))
    host[:] = 2.0 * surf(vex.vector(data=hx[:k], context=host.context),
                         vex.vector(data=hy[:k], context=host.context)) + 1.0
    err = np.abs(got[:k] - host.to_numpy()).max()
    assert err <= 1e-10, err
    print(f"check against the CPU evaluation of {k} points: ok "
          f"(max |err| {err:.1e})")
    print(f"max deviation from f: "
          f"{np.abs(got - (2.0 * f(hx, hy) + 1.0)).max():.3e}")


if __name__ == "__main__":
    main()
