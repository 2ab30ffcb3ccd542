#!/usr/bin/env python
"""FFT profiling (examples/fft_profile.py's counterpart), through the
PyTorch/CUDA port: a plan's making against its use, for a power-of-two
and a prime 2-D size, under the hierarchical profiler::

    python examples/torch/fft_profile.py                # the cards
    python examples/torch/fft_profile.py --device cpu --sizes 16 17

The profiler's spans are device-synchronised (``tic_cl``) and read the
host clock; each size's last transform is checked against
``torch.fft.fft2`` in c128.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name  # noqa: E402


def profile(ctx, size, runs, repeats):
    n = size * size
    a = vex.vector(n, dtype=np.complex64, context=ctx)
    b = vex.vector(n, dtype=np.complex64, context=ctx)
    a[:] = vex.element_index() * (1.0 / n)
    prof = vex.profiler(name=f"fft ({size}, {size}) on {device_name(ctx)}",
                        context=ctx)
    for _ in range(repeats):
        prof.tic_cl("init")
        f = vex.FFT((size, size), context=ctx)
        prof.toc("init")
        prof.tic_cl("apply")
        for _ in range(runs):
            b[:] = f(a)
        prof.toc("apply")
    print(prof)
    want = torch.fft.fft2(a.storage.to(torch.complex128).reshape(size, size))
    err = float((b.storage.reshape(size, size) - want).abs().max()
                / want.abs().max())
    assert err <= 1e-5, (size, err)
    print(f"check ({size}, {size}) against torch.fft.fft2: ok "
          f"(rel err {err:.1e})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--sizes", type=int, nargs="*", default=[512, 521],
                    help="each a 2-D size (size, size); 521 is prime")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)
    for size in args.sizes:
        profile(ctx, size, args.runs, args.repeats)


if __name__ == "__main__":
    main()
