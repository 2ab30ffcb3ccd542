#!/usr/bin/env python
"""A complex-valued SpMV (examples/complex_spmv.py's counterpart), through
the PyTorch/CUDA port::

    python examples/torch/complex_spmv.py               # the cards, n 1024
    python examples/torch/complex_spmv.py --device cpu --n 64

A tridiagonal complex matrix (a 1-D Helmholtz-like operator) times a
complex64 vector, with complex multiplication, held against a dense
product in numpy; scipy's sparse product too, where scipy imports.
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
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)

    n = args.n
    rng = np.random.default_rng(42)
    rows, cols, vals = [], [], []
    k = 0.5 + 0.25j
    for i in range(n):
        for j, v in ((i - 1, -1.0 + 0j), (i, 2.0 + k), (i + 1, -1.0 + 0j)):
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(v)
    rows, cols = np.asarray(rows), np.asarray(cols)
    vals = np.asarray(vals, np.complex64)
    ptr = np.searchsorted(rows, np.arange(n + 1))
    A = vex.SpMat(n, n, ptr, cols, vals, context=ctx)
    hx = (rng.random(n) + 1j * rng.random(n)).astype(np.complex64)
    x = vex.vector(data=hx, context=ctx)
    y = vex.vector(n, dtype=np.complex64, context=ctx)
    y[:] = A * x

    dense = np.zeros((n, n), np.complex128)
    dense[rows, cols] = vals
    want = dense @ hx.astype(np.complex128)
    err = np.abs(y.to_numpy() - want).max()
    print(f"matrix format: {A.device.format}")
    print(f"max |err| against the dense complex product: {err:.2e}")
    assert err <= 1e-5 * np.abs(want).max()
    print("check A * x: ok")
    try:
        import scipy.sparse as sp
    except ImportError:
        print("scipy does not import: its product is skipped")
        return
    ref = sp.csr_matrix((vals, (rows, cols)), shape=(n, n)) @ hx
    err = np.abs(y.to_numpy() - ref).max()
    print(f"max |err| against scipy's product: {err:.2e}")
    assert err <= 1e-5 * np.abs(ref).max()
    print("check A * x against scipy: ok")


if __name__ == "__main__":
    main()
