"""Lorenz-ensemble ODE model — the reference's flagship workload.

Port of ``vexcl_tpu/models/lorenz.py``.  The published comparison for the
reference (SIAM SISC 35.5, cited in docs/talks.rst:40-48) is a parameter
sweep of the Lorenz attractor integrated with RK4; examples/symbolic.cpp
builds it with the symbolic generator.  One RK4 step over symbolic state
is recorded once; each ``step()`` is then one launch of the k-output
assignment kernel, which reads x, y, z and R and writes x, y and z in
place (28 bytes an element in f32: 0.0350 ms at 2^22 on an H100's 3.35
TB/s, against ~75 flops an element).

``from_arrays`` builds the ensemble from given state, e.g. a JAX package
ensemble's ``state()`` and ``R``, so both packages step the same one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import generator
from ..context import Context, current_context
from ..vector import vector

__all__ = ["LorenzEnsemble"]


class LorenzEnsemble:
    def __init__(self, n: int, r_min: float = 0.1, r_max: float = 50.0,
                 sigma: float = 10.0, b: float = 8.0 / 3.0, dt: float = 0.01,
                 dtype=np.float32, *, context: Optional[Context] = None,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        x, y, z = (rng.random(n) * 10 for _ in range(3))
        self._setup(x, y, z, np.linspace(r_min, r_max, n), sigma, b, dt,
                    dtype, context)

    @classmethod
    def from_arrays(cls, x, y, z, R, sigma: float = 10.0, b: float = 8.0 / 3.0,
                    dt: float = 0.01, dtype=None, *,
                    context: Optional[Context] = None) -> "LorenzEnsemble":
        """The ensemble with state (x, y, z) and parameters R (arrays or
        tensors of one length; their own type unless ``dtype`` is given)."""
        obj = cls.__new__(cls)
        obj._setup(x, y, z, R, sigma, b, dt, dtype, context)
        return obj

    def _setup(self, x, y, z, R, sigma, b, dt, dtype, context) -> None:
        self.context = context or current_context()
        self.dt = dt
        self.x, self.y, self.z, self.R = (
            vector(data=a, dtype=dtype, context=self.context)
            for a in (x, y, z, R))
        self.n = self.x.size

        def sys_fn(state, R):
            x, y, z = state
            return (sigma * (y - x), R * x - y - x * z, x * y - b * z)

        sx, sy, sz, sR = (generator.symbolic() for _ in range(4))
        nx, ny, nz = self._rk4(sys_fn, (sx, sy, sz), sR, dt)
        sx.assign(nx)
        sy.assign(ny)
        sz.assign(nz)
        self._step = generator.build_kernel(
            "lorenz_rk4", [sx, sy, sz], params=[sx, sy, sz, sR])

    @staticmethod
    def _rk4(sys_fn, state, R, dt):
        k1 = sys_fn(state, R)
        s2 = tuple(s + 0.5 * dt * k for s, k in zip(state, k1))
        k2 = sys_fn(s2, R)
        s3 = tuple(s + 0.5 * dt * k for s, k in zip(state, k2))
        k3 = sys_fn(s3, R)
        s4 = tuple(s + dt * k for s, k in zip(state, k3))
        k4 = sys_fn(s4, R)
        return tuple(
            s + dt / 6.0 * (a + 2 * b_ + 2 * c + d)
            for s, a, b_, c, d in zip(state, k1, k2, k3, k4))

    def step(self, nsteps: int = 1) -> None:
        for _ in range(nsteps):
            self._step(self.x, self.y, self.z, self.R)

    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.x.to_numpy(), self.y.to_numpy(), self.z.to_numpy()
