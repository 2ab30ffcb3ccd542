#!/usr/bin/env python
"""FFT benchmark (examples/fft_benchmark.py's counterpart), through the
PyTorch/CUDA port: 1-D and 2-D, power-of-two and other sizes, GFLOP/s
as 5 N log2 N over the time of one transform::

    python examples/torch/fft_benchmark.py              # the cards
    python examples/torch/fft_benchmark.py --device cpu --sizes 1024 105 \\
        --shapes 16x16

Each size's plan (``ops/fft.Plan``, cuFFT on the card) transforms into
one output tensor in a plain Python loop, timed by CUDA events on the
card and by the host clock on the CPU, after a check against
``torch.fft`` in c128.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _common import context, device_name, ms_per_call  # noqa: E402
from vexcl_tpu_torch.ops.fft import Plan  # noqa: E402

SIZES = [1 << k for k in (10, 14, 18, 20, 22)] + [3 * 5 * 7 * 1024, 1000000]
SHAPES = ["1024x1024", "2048x2048"]


def run(shape, ctx, reps, name):
    dev = ctx.device
    plan = Plan(shape, None, False, np.complex64)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.complex(torch.rand(shape, generator=g, device=dev),
                      torch.rand(shape, generator=g, device=dev))
    out = torch.empty(shape, dtype=torch.complex64, device=dev)
    plan(x, out=out)
    want = torch.fft.fftn(x.to(torch.complex128))
    err = float((out - want).abs().max() / want.abs().max())
    assert err <= 1e-5, (shape, err)
    ms = ms_per_call(lambda: plan(x, out=out), ctx, reps)
    n = int(np.prod(shape))
    gflops = 5 * n * np.log2(n) / ms / 1e6
    print(f"{'x'.join(map(str, shape)):>12} {ms:>10.4f}ms {gflops:>8.1f} "
          f"GFLOP/s  rel err {err:.1e} on {name}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--sizes", type=int, nargs="*", default=SIZES,
                    help="the 1-D sizes")
    ap.add_argument("--shapes", nargs="*", default=SHAPES,
                    help="the 2-D shapes, as AxB")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    ctx = context(args.device)
    name = device_name(ctx)
    print(f"device: {name}")
    print(f"{'size':>12} {'time':>12} {'GFLOPS':>8}")
    for n in args.sizes:
        run((n,), ctx, args.reps, name)
    for s in args.shapes:
        run(tuple(int(d) for d in s.split("x")), ctx, args.reps, name)
    print("check every transform against torch.fft in c128: ok")


if __name__ == "__main__":
    main()
