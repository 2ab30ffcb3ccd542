"""Interop: numpy containers and a conjugate-gradient solver.

Port of part of ``vexcl_tpu/interop.py`` (the vexcl/external/* analog):
``from_numpy``, ``to_numpy`` and ``cg``.  The JAX package's ``cg`` is one
jitted ``lax.while_loop``; here it is written with the port's own API, so
every step runs through the port's kernels: ``A * p`` the matrix's
SpMV kernel (DIA, SELL, CSR), each ``Sum`` the map-reduce kernel, each
vector update the expression kernel.  The stopping rule is the JAX package's (interop.py:89-139):
iterate while ``r.r > tol*tol`` and ``it < maxiter``.  Each ``Sum``
returns a host scalar, so every iteration synchronises with the device
twice.

The dlpack, torch, scipy and BiCGStab entry points are later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .ops.reductor import SUM, Reductor
from .vector import vector

__all__ = ["from_numpy", "to_numpy", "cg"]


def from_numpy(arr: np.ndarray, *, context=None) -> vector:
    return vector(data=np.asarray(arr), context=context)


def to_numpy(vec: vector) -> np.ndarray:
    return vec.to_numpy()


def cg(A, b: vector, x0: Optional[vector] = None, tol: float = 1e-8,
       maxiter: Optional[int] = None) -> Tuple[vector, int]:
    """Conjugate gradients for symmetric positive definite ``A``."""
    n = b.size
    maxiter = maxiter if maxiter is not None else 10 * n
    ctx, dt = b.context, b.dtype
    x = x0.copy() if x0 is not None else vector(n, dt, context=ctx)
    r = vector(n, dt, context=ctx)
    p = vector(n, dt, context=ctx)
    Ap = vector(n, dt, context=ctx)
    Sum = Reductor(SUM, context=ctx)

    r[:] = b - A * x
    p[:] = r
    rs = Sum(r * r)
    it = 0
    while rs > tol * tol and it < maxiter:
        Ap[:] = A * p
        alpha = rs / Sum(p * Ap)
        x += alpha * p
        r -= alpha * Ap
        rs_new = Sum(r * r)
        p[:] = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it
