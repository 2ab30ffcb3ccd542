#!/usr/bin/env python
"""Hello world (examples/hello.py's counterpart), through the PyTorch/CUDA
port: list the context, run one fused expression, print the result::

    python examples/torch/hello.py                      # the cards
    python examples/torch/hello.py --device cpu --n 1024
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--n", type=int, default=1 << 16)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)

    n = args.n
    a = vex.vector(data=np.arange(n, dtype=np.float32), context=ctx)
    b = vex.vector(n, dtype=np.float32, context=ctx)
    b[:] = 0.5
    c = vex.vector(n, dtype=np.float32, context=ctx)
    c[:] = 2 * a + vex.sqrt(b)          # one fused kernel
    print(c)
    want = 2 * np.arange(n, dtype=np.float32) + np.sqrt(np.float32(0.5))
    np.testing.assert_allclose(c.to_numpy(), want, rtol=1e-6)
    print("check 2*a + sqrt(b): ok")


if __name__ == "__main__":
    main()
