#!/usr/bin/env python
"""Complex multiply and divide on vectors (examples/complex_simple.py's
counterpart), through the PyTorch/CUDA port::

    python examples/torch/complex_simple.py             # the cards
    python examples/torch/complex_simple.py --device cpu

complex64 is a type of the expression engine, as in the JAX package:
``x * y`` and ``x / y`` are complex multiplication and division (the
card's kernels carry (re, im) pairs), and a ``vex.function`` over complex
operands fuses like any other.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context  # noqa: E402


@vex.function
def cmul(a, b):
    # the reference's VEX_FUNCTION(cmul), written against complex values
    return a * b


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--n", type=int, default=16)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)

    n = args.n
    i = np.arange(n)
    x = (i + 1j * (n - i)).astype(np.complex64)
    y = ((n - i) + 1j * i).astype(np.complex64)
    X = vex.vector(data=x, context=ctx)
    Y = vex.vector(data=y, context=ctx)
    T = vex.vector(n, dtype=np.complex64, context=ctx)

    T[:] = cmul(X, Y)           # the user-function route
    tt = T.to_numpy()
    for k in range(min(n, 16)):
        print(f"X * Y = {x[k]} * {y[k]} = {tt[k]}")
    assert np.allclose(tt, x * y, rtol=1e-5)
    print("check X * Y: ok")

    T[:] = X / Y                # the operator route
    tt = T.to_numpy()
    for k in range(min(n, 16)):
        print(f"X / Y = {x[k]} / {y[k]} = {tt[k]}")
    assert np.allclose(tt, x / y, rtol=1e-5)
    print("check X / Y: ok")


if __name__ == "__main__":
    main()
