#!/usr/bin/env python
"""Iterative solvers on the port's containers (examples/
viennacl_solvers.py's counterpart), through the PyTorch/CUDA port::

    python examples/torch/viennacl_solvers.py           # the cards, 2^12
    python examples/torch/viennacl_solvers.py --device cpu --n 256

CG and BiCGStab on the device (``interop.cg``, ``interop.bicgstab``: the
ViennaCL-solvers-on-vex-types analog), and scipy's CG through the
``LinearOperator`` shim where scipy imports.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402

import vexcl_tpu_torch as vex  # noqa: E402
from _common import context, device_name, ms_per_call  # noqa: E402
from vexcl_tpu_torch.interop import (as_linear_operator, bicgstab,  # noqa
                                     cg)


def poisson1d(n):
    ptr, col, val = [0], [], []
    for i in range(n):
        for j, v in ((i - 1, -1.0), (i, 2.05), (i + 1, -1.0)):
            if 0 <= j < n:
                col.append(j)
                val.append(v)
        ptr.append(len(col))
    return np.asarray(ptr), np.asarray(col, np.int32), np.asarray(val)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the cards)")
    ap.add_argument("--n", type=int, default=1 << 12)
    args = ap.parse_args()
    ctx = context(args.device)
    print(ctx)
    name = device_name(ctx)
    n = args.n
    ptr, col, val = poisson1d(n)
    A = vex.SpMat(n, n, ptr, col, val, fmt="csr", context=ctx)
    b = vex.vector(data=np.ones(n), context=ctx)

    x, iters = cg(A, b, tol=1e-10, maxiter=4 * n)
    r = np.linalg.norm(np.ones(n) - vex.eval(A * x).cpu().numpy())
    ms = ms_per_call(lambda: cg(A, b, tol=1e-10, maxiter=4 * n)[0], ctx, 1)
    print(f"device CG: {iters} iters, |r| = {r:.2e}, {ms:.3f} ms on {name}")
    assert r <= 1e-8
    print("check CG: ok")

    try:
        import scipy.sparse.linalg as sla
    except ImportError:
        print("scipy does not import: its CG is skipped")
    else:
        xs, info = sla.cg(as_linear_operator(A), np.ones(n), rtol=1e-10)
        match = np.allclose(x.to_numpy(), xs, atol=1e-5)
        print(f"scipy CG through LinearOperator: info={info}, "
              f"match={match}")
        assert info == 0 and match
        print("check scipy CG: ok")

    # a non-symmetric system: BiCGStab, the second reference solver
    val = np.asarray(val, np.float64)
    val[::3] *= 1.3
    B = vex.SpMat(n, n, ptr, col, val, fmt="csr", context=ctx)
    xb, itb = bicgstab(B, b, tol=1e-12, maxiter=4 * n)
    rb = np.linalg.norm(np.ones(n) - vex.eval(B * xb).cpu().numpy())
    print(f"device BiCGStab: {itb} iters, |r| = {rb:.2e} on {name}")
    assert rb <= 1e-9
    print("check BiCGStab: ok")


if __name__ == "__main__":
    main()
