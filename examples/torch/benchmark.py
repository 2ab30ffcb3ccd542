#!/usr/bin/env python
"""Library-level benchmark (examples/benchmark.py's counterpart), through
the PyTorch/CUDA port: every measurement goes through the public API
(vectors and expressions), so it includes the dispatch path a user sees::

    python examples/torch/benchmark.py                  # the cards, 2^20
    python examples/torch/benchmark.py --device cpu --log2 12

Each result is first checked against PyTorch on the same data, then
timed: CUDA events on the card (the last result read back once), the
host clock on the CPU.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name, ms_per_call  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--log2", type=int, default=20,
                    help="the vectors' length, a power of two")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)
    name = device_name(ctx)
    n = 1 << args.log2
    dt = np.float32
    rng = np.random.default_rng(0)
    a, b, c, d = (vex.vector(data=rng.random(n).astype(dt), context=ctx)
                  for _ in range(4))
    ta, tb, tc, td = (v.storage.clone() for v in (a, b, c, d))

    # the checks: one call of each against PyTorch on the same data
    a.assign(2.0 * vex.tag(1, a) + b)
    ta = 2.0 * ta + tb
    assert torch.allclose(a.storage, ta, rtol=1e-6)
    a.assign(b + c * d, "+=")
    ta += tb + tc * td
    assert torch.allclose(a.storage, ta, rtol=1e-6)
    Sum = vex.Reductor(vex.SUM, context=ctx)
    s = float(Sum(a * b))
    assert abs(s - float(torch.dot(ta.double(), tb.double()))) \
        <= 1e-4 * abs(s)
    rnd = vex.Random(dt, "philox")
    idx = vex.element_index(0, n)
    a.assign(rnd(idx, 42))
    assert 0.0 <= float(a.storage.min()) and float(a.storage.max()) < 1
    k = vex.vector(data=rng.integers(0, 1 << 30, n).astype(np.int32),
                   context=ctx)
    k0 = k.storage.clone()
    vex.sort(k)
    assert torch.equal(k.storage, torch.sort(k0).values)
    got = vex.inclusive_scan(a).storage.double()
    want = torch.cumsum(a.storage.double(), 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want[-1])
    print("check saxpy, fused, reduction, philox, sort, scan: ok")

    # the timings (benchmark.cpp's rows)
    ms = ms_per_call(lambda: a.assign(2.0 * vex.tag(1, a) + b), ctx,
                     args.reps)
    print(f"saxpy       : {3 * n * 4 / ms / 1e6:8.1f} GB/s "
          f"({ms:.4f} ms) on {name}")
    ms = ms_per_call(lambda: a.assign(b + c * d, "+="), ctx, args.reps)
    print(f"fused expr  : {5 * n * 4 / ms / 1e6:8.1f} GB/s "
          f"({ms:.4f} ms) on {name}")
    ms = ms_per_call(lambda: Sum(a * b), ctx, args.reps)
    print(f"reduction   : {2 * n * 4 / ms / 1e6:8.1f} GB/s "
          f"({ms:.4f} ms) on {name}")
    ms = ms_per_call(lambda: a.assign(rnd(idx, 42)), ctx, args.reps)
    print(f"philox      : {n / ms / 1e6:8.2f} Grand/s "
          f"({ms:.4f} ms) on {name}")
    ms = ms_per_call(lambda: vex.sort(k), ctx, 5)
    print(f"sort        : {n / ms / 1e3:8.1f} Mkeys/s "
          f"({ms:.4f} ms, already sorted keys) on {name}")
    ms = ms_per_call(lambda: vex.inclusive_scan(a), ctx, 5)
    print(f"scan        : {n / ms / 1e6:8.2f} Gelem/s "
          f"({ms:.4f} ms) on {name}")


if __name__ == "__main__":
    main()
