"""Multilevel B-spline approximation (MBA) of scattered data.

Port of ``vexcl_tpu/ops/mba.py`` (vexcl/mba.hpp:66-800: ``mba`` :160-240,
``mba_interp`` :66-73, ``append_refined`` :417-444), Lee, Wolberg and
Shin's MBA::

    interp = vex.mba(lo, hi, coords, values, grid=(16, 16))
    z[:] = interp(x, y)            # x, y: vectors or expressions

The fit runs on the host in numpy, as in the JAX package (and the
reference): a hierarchy of cubic B-spline control lattices fitted to the
residuals, each coarser lattice refined exactly onto the next dyadic grid
and added in, so that one flattened control lattice remains.

An interpolant of 1-3 axes (``interp(x, y)``) is one ``MBAExpr`` node,
evaluated by a hand-written CUDA kernel (``ops/cuda_mba.py``,
``csrc/mba.cu``): not elementwise, so ``z[:] = interp(x, y)`` is one
launch straight into z (the coordinates read in place), and a larger
tree (``2 * interp(x, y) + w``) runs it into a temporary first (the
faster of the two forms there, against the fused tree, on the card:
PERF.md §6).  An interpolant of more axes is the elementwise tree below,
a route by structure.

The tree (``mba_device_eval``), the kernel's plain version, is made of
existing nodes and fuses into the assignment kernel (V1,
``expr/triton_emit.py``): the coordinates clamped to the domain and
floored, the tap box's base index clamped explicitly (in f32 ``grid -
1e-12`` rounds to ``grid``; a tap must never leave its table, where a
``PointerDeref`` reads NaN), the cubic weights, and one
``PointerDeref`` (``expr/pointer.py``) a tap: 4^d loads from the
flattened lattice, or, in the patch form, 4^d loads of one contiguous
row of the widened table whose row j holds the tap box based at control
j.  The domain, the cell sizes and the strides are Python numbers, which
cross into the kernel as scalar leaves: two interpolants of one
structure share a kernel and differ in its arguments.

The tables live on the device in the coordinates' float type (f64 for f64
coordinates, else f32), made once per type and device (the kernel's
table once per type and device).  The tree evaluates through
the lattice: on an H100 the patch form took 0.864 ms for the lattice
form's 0.601 at 2^24 f32 points of a 259^2 lattice (``chip_smoke.py``
phase 14), where the JAX package takes the patch for the TPU's gathers.
The patch table (4^d times the lattice, built where it fits
``PATCH_BUDGET_BYTES``) serves ``mba_device_eval(..., patch=...)``.
"""

from __future__ import annotations

from itertools import product
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..expr.builtins import BUILTINS
from ..expr.node import (ArrayTerminal, CastExpr, ConstantTerminal, EmitEnv,
                         Expr, VectorTerminal, as_expr, expression_properties,
                         infer_types)
from ..expr.pointer import PointerDeref
from ..types import code_of, dtype_of_code, join, to_inexact

__all__ = ["mba", "mba_device_eval", "MBAExpr", "PATCH_BUDGET_BYTES",
           "KERNEL_AXES"]

#: the widened patch table is built where it takes at most this many
#: bytes (in f64), as the JAX package's default budget
PATCH_BUDGET_BYTES = 64 << 20


def _bspline_weights_np(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Cubic uniform B-spline basis at fractional position t in [0,1)."""
    t2, t3 = t * t, t * t * t
    return (
        (1 - t) ** 3 / 6,
        (3 * t3 - 6 * t2 + 4) / 6,
        (-3 * t3 + 3 * t2 + 3 * t + 1) / 6,
        t3 / 6,
    )


def _point_setup_np(lo, hi, grid, coords):
    d = len(grid)
    h = [(hi[k] - lo[k]) / grid[k] for k in range(d)]
    u = [np.clip((coords[k] - lo[k]) / h[k], 0, grid[k] - 1e-12)
         for k in range(d)]
    # the explicit clamp of the device form (f64 hits the
    # `grid - 1e-12 == grid` rounding at grid ~9e3)
    i0 = [np.minimum(np.floor(u[k]).astype(np.int64), grid[k] - 1)
          for k in range(d)]
    t = [u[k] - i0[k] for k in range(d)]
    w_axes = [_bspline_weights_np(t[k]) for k in range(d)]
    return i0, w_axes


def _fit_level(lo, hi, grid, coords, vals):
    """BA algorithm for one lattice level (mba.hpp control-lattice fit)."""
    d = len(grid)
    shape = tuple(g + 3 for g in grid)
    delta = np.zeros(shape)
    omega = np.zeros(shape)
    i0, w_axes = _point_setup_np(lo, hi, grid, coords)

    s2 = np.zeros(len(vals))
    for offs in product(range(4), repeat=d):
        w = np.ones(len(vals))
        for k in range(d):
            w = w * w_axes[k][offs[k]]
        s2 += w * w
    s2 = np.where(s2 > 0, s2, 1.0)

    for offs in product(range(4), repeat=d):
        w = np.ones(len(vals))
        for k in range(d):
            w = w * w_axes[k][offs[k]]
        phi = w * vals / s2
        idx = tuple(i0[k] + offs[k] for k in range(d))
        np.add.at(delta, idx, w * w * phi)
        np.add.at(omega, idx, w * w)

    return np.where(omega > 1e-20, delta / np.where(omega > 0, omega, 1), 0.0)


#: cubic B-spline dyadic subdivision mask (1/8)[1,4,6,4,1]: a cubic basis
#: at knot spacing h is exactly these five bases at h/2 (the reference's
#: append_refined stencil, mba.hpp:417-444)
_SUBDIV = (0.125, 0.5, 0.75, 0.5, 0.125)


def _refine_axis(a: np.ndarray, ax: int, g: int) -> np.ndarray:
    """Refine one lattice axis from g cells (g+3 controls) to 2g cells:
    coarse control i contributes _SUBDIV[d] to fine control 2i + d - 3."""
    a = np.moveaxis(a, ax, 0)
    out = np.zeros((2 * g + 3,) + a.shape[1:], dtype=a.dtype)
    for d, s in enumerate(_SUBDIV):
        i_min = max(0, (4 - d) // 2)
        i_max = min(g + 2, (2 * g + 5 - d) // 2)
        j0 = 2 * i_min + d - 3
        cnt = i_max - i_min + 1
        out[j0: j0 + 2 * cnt: 2] += s * a[i_min: i_max + 1]
    return np.moveaxis(out, 0, ax)


def _refine_np(lat: np.ndarray, grid: Sequence[int]) -> np.ndarray:
    """Exact dyadic refinement: a control lattice on grid g as the same
    spline on grid 2g (the tensor product of ``_refine_axis``)."""
    for ax, g in enumerate(grid):
        lat = _refine_axis(lat, ax, g)
    return lat


def _eval_level_host(lo, hi, grid, lattice, coords):
    d = len(grid)
    i0, w_axes = _point_setup_np(lo, hi, grid, coords)
    out = np.zeros(len(coords[0]))
    for offs in product(range(4), repeat=d):
        w = np.ones(len(coords[0]))
        for k in range(d):
            w = w * w_axes[k][offs[k]]
        out += w * lattice[tuple(i0[k] + offs[k] for k in range(d))]
    return out


def _lattice_strides(grid):
    shape = tuple(g + 3 for g in grid)
    return np.concatenate(
        [np.cumprod(shape[::-1])[::-1][1:], [1]]).astype(int)


def _code(expr: Expr) -> str:
    return infer_types(expr)[id(expr)]


def _spline_setup(lo, hi, grid, coords):
    """The clamp, floor and weights of both forms, as expression nodes:
    (the i32 base index of each point's tap box per axis, the four cubic
    weights per axis).  ``i0`` is clamped explicitly: in f32 ``grid -
    1e-12`` rounds to ``grid``, and ``t`` is taken from the clamped index,
    so t -> 1 at the top edge, where the weights still give the boundary
    value.  The domain and the grid cross as scalar leaves; the spline's
    own coefficients are constants of the kernel."""
    clamp, floor, minimum = (BUILTINS[k] for k in ("clamp", "floor", "min"))
    c = {v: ConstantTerminal(v) for v in (0, 1, 3, 4, 6, -3)}
    d = len(lo)
    i0, w_axes = [], []
    for k in range(d):
        h = (hi[k] - lo[k]) / grid[k]
        u = clamp((coords[k] - lo[k]) / h, c[0], grid[k] - 1e-12)
        ik = minimum(CastExpr(torch.int32, floor(u)), grid[k] - 1)
        t = u - CastExpr(dtype_of_code(_code(u)), ik)
        s = c[1] - t
        t2 = t * t
        t3 = t2 * t
        w_axes.append((s * s * s / c[6],
                       (c[3] * t3 - c[6] * t2 + c[4]) / c[6],
                       (c[-3] * t3 + c[3] * t2 + c[3] * t + c[1]) / c[6],
                       t3 / c[6]))
        i0.append(ik)
    return i0, w_axes


def _flat_table(t: torch.Tensor) -> ArrayTerminal:
    return ArrayTerminal(t.reshape(-1))


def mba_device_eval(lo, hi, grids, lattices, coords, patch=None) -> Expr:
    """The evaluation of a fitted multilevel B-spline at ``coords`` (d
    vectors or expressions), as an elementwise expression (mba.hpp device
    codegen :240-800): the sum over the levels of ``grids``/``lattices``
    (tensors of (g + 3) controls an axis) of each point's 4^d taps
    weighted by the cubic weights; or, with ``patch`` (the (controls, 4^d)
    widened table of a one-level fit), the 4^d taps read from the row of
    the tap box's base, contracted axis by axis from the last."""
    d = len(lo)
    coords = [as_expr(c) for c in coords]
    if patch is not None:
        (grid,) = grids
        i0, w_axes = _spline_setup(lo, hi, grid, coords)
        strides = _lattice_strides(grid)
        taps = 4 ** d
        base = i0[0] * int(strides[0])
        for k in range(1, d):
            base = base + i0[k] * int(strides[k])
        tab = _flat_table(patch)
        row = base * ConstantTerminal(taps)
        vals = [PointerDeref(tab, row + ConstantTerminal(t))
                for t in range(taps)]
        # the separable contraction over the (4, ..., 4) tap box: the
        # last axis first, as the JAX package sums it
        for k in range(d - 1, -1, -1):
            w = w_axes[k]
            vals = [((v[0] * w[0] + v[1] * w[1]) + v[2] * w[2]) + v[3] * w[3]
                    for v in (vals[j:j + 4] for j in range(0, len(vals), 4))]
        return vals[0]
    out = None
    for grid, lattice in zip(grids, lattices):
        i0, w_axes = _spline_setup(lo, hi, grid, coords)
        strides = _lattice_strides(grid)
        base = i0[0] * int(strides[0])
        for k in range(1, d):
            base = base + i0[k] * int(strides[k])
        tab = _flat_table(lattice)
        for offs in product(range(4), repeat=d):
            w = w_axes[0][offs[0]]
            for k in range(1, d):
                w = w * w_axes[k][offs[k]]
            off = sum(int(offs[k]) * int(strides[k]) for k in range(d))
            term = w * PointerDeref(tab, base + off)
            out = term if out is None else out + term
    return out


#: the axes the CUDA kernel takes; an interpolant of more keeps the tree
KERNEL_AXES = (1, 2, 3)


class MBAExpr(Expr):
    """An interpolant at d coordinate expressions, evaluated by the CUDA
    kernel (``cuda_mba.mba_eval``): not elementwise (``hoist`` runs it
    into a temporary), and written straight into a target of its type
    (``direct_dtype``).  Its signature is its structure (the axes and the
    type): two interpolants of one structure share everything but their
    tables."""

    _opname = "mba"
    _elementwise = False

    def __init__(self, interp: "mba", dtype: torch.dtype,
                 lattice: torch.Tensor, coords: Sequence[Expr]):
        self.interp = interp
        self.dtype = dtype
        self.lattice = lattice
        self.children = tuple(coords)

    def extra_sig(self) -> str:
        return f"{len(self.children)}:{self.dtype}"

    def _infer(self, child_codes):
        return code_of(self.dtype)

    def direct_dtype(self) -> torch.dtype:
        return self.dtype

    def _coord(self, c: Expr, device: torch.device, n: int) -> torch.Tensor:
        """A coordinate as a contiguous tensor of the interpolant's type:
        a vector of that type read in place, anything else evaluated."""
        if isinstance(c, VectorTerminal):
            t = c.vec.storage
            if t.dtype == self.dtype and t.device == device \
                    and t.numel() == n:
                return t
        from ..expr.compile import evaluate

        return evaluate(c, n=n, out_dtype=self.dtype, device=device)

    def materialize(self, device: torch.device, n: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The interpolant's values on ``device`` (n of them; into ``out``
        where it is given)."""
        from . import cuda_mba

        n = out.numel() if out is not None else (n or self.size_hint())
        if n is None:
            raise ValueError("an interpolant over no vector needs a size")
        coords = [self._coord(c, device, n) for c in self.children]
        if out is None:
            out = torch.empty(n, dtype=self.dtype, device=device)
        ip = self.interp
        tab = (ip.kernel_table(self.dtype, device)
               if device.type == "cuda" else None)
        cuda_mba.mba_eval(out, coords, self.lattice.to(device), ip.lo, ip.hi,
                          ip.grids[0], tab)
        return out

    def emit(self, env: EmitEnv):
        return self.materialize(env.device, env.n)


class mba:
    """vex::mba<NDIM> (mba.hpp:160-240).

    Parameters mirror the reference's constructor: the domain ``lo``/
    ``hi``, scattered ``coords`` (d arrays) and ``values``, the initial
    ``grid`` density, the number of refinement ``levels`` and a residual
    ``tol``.  Calling it on d coordinate vectors or expressions gives the
    interpolant's expression."""

    def __init__(self, lo: Sequence[float], hi: Sequence[float],
                 coords: Sequence[np.ndarray], values: np.ndarray,
                 grid: Sequence[int] = (8,), levels: int = 8,
                 tol: float = 1e-8, *, context=None):
        lo = tuple(float(v) for v in np.atleast_1d(lo))
        hi = tuple(float(v) for v in np.atleast_1d(hi))
        self.lo, self.hi = lo, hi
        self.ndim = len(lo)
        self.context = context
        coords = [np.asarray(c, dtype=np.float64) for c in coords]
        vals = np.asarray(values, dtype=np.float64).copy()
        grid = tuple(int(g) for g in np.atleast_1d(grid))
        if len(grid) == 1 and self.ndim > 1:
            grid = grid * self.ndim
        if int(levels) < 1:
            raise ValueError("mba needs levels >= 1")

        # fit the residual hierarchy, flattening as it goes: each coarser
        # lattice is refined exactly onto the next (dyadic) grid and added
        # in (append_refined, mba.hpp:271,417-444), so one lattice remains
        self.fit_grids: List[Tuple[int, ...]] = []
        cur = grid
        resid = vals
        psi = None
        prev = grid
        for _ in range(levels):
            lvl = _fit_level(lo, hi, cur, coords, resid)
            self.fit_grids.append(tuple(cur))
            resid = resid - _eval_level_host(lo, hi, cur, lvl, coords)
            psi = lvl if psi is None else _refine_np(psi, prev) + lvl
            prev = cur
            if np.abs(resid).max(initial=0.0) < tol:
                break
            cur = tuple(2 * g for g in cur)

        self.grids = [tuple(prev)]
        #: the flattened control lattice (f64, on the host)
        self.lattice = psi
        self.residual = float(np.abs(resid).max(initial=0.0))

        # the widened patch table: row j holds the 4^d controls of the tap
        # box whose base is control j
        self.patch = None
        taps = 4 ** self.ndim
        flat = psi.reshape(-1)
        if flat.size * taps * flat.itemsize <= PATCH_BUDGET_BYTES:
            strides = _lattice_strides(self.grids[0])
            patch = np.empty((flat.size, taps), dtype=flat.dtype)
            base = np.arange(flat.size)
            for t_i, offs in enumerate(product(range(4), repeat=self.ndim)):
                off = sum(int(offs[k]) * int(strides[k])
                          for k in range(self.ndim))
                # rows whose tap box would run past the end are never a
                # base (i0[k] <= grid - 1); the clip keeps them in bounds
                patch[:, t_i] = flat[np.minimum(base + off, flat.size - 1)]
            self.patch = patch
        #: (dtype, device) -> (lattice, patch or None) on the device
        self._tables: Dict[tuple, tuple] = {}
        #: (dtype, device) -> the CUDA kernel's table
        self._kernel_tables: Dict[tuple, torch.Tensor] = {}

    def tables(self, dtype: torch.dtype, device: torch.device):
        """(the flattened lattice, the flattened patch table or None) in
        ``dtype`` on ``device``, made at the first request."""
        key = (dtype, device)
        tabs = self._tables.get(key)
        if tabs is None:
            lat = torch.from_numpy(self.lattice.reshape(-1)).to(device, dtype)
            patch = (None if self.patch is None else
                     torch.from_numpy(self.patch.reshape(-1)).to(device,
                                                                 dtype))
            tabs = self._tables[key] = (lat, patch)
        return tabs

    def kernel_table(self, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
        """The CUDA kernel's table in ``dtype`` (``cuda_mba.table``), made
        at the first request."""
        from . import cuda_mba

        key = (dtype, device)
        tab = self._kernel_tables.get(key)
        if tab is None:
            shape = tuple(g + 3 for g in self.grids[0])
            lat = self.tables(dtype, device)[0].reshape(shape)
            tab = self._kernel_tables[key] = cuda_mba.table(lat)
        return tab

    def __call__(self, *coords: Any) -> Expr:
        """The interpolant at ``coords``: the kernel's node for 1-3 axes,
        else the tree through the flattened lattice."""
        if len(coords) != self.ndim:
            raise ValueError(f"mba expects {self.ndim} coordinate "
                             "expressions")
        coords = [as_expr(c) for c in coords]
        types = infer_types(*coords)
        code = types[id(coords[0])]
        for c in coords[1:]:
            code = join(code, types[id(c)])
        dtype = (torch.float64 if to_inexact(code) in ("f64", "f*")
                 else torch.float32)
        ctx = self.context
        if ctx is None:
            ctx = next((expression_properties(c)[1] for c in coords
                        if expression_properties(c)[1] is not None), None)
        if ctx is None:
            from ..context import current_context

            ctx = current_context()
        lat, _ = self.tables(dtype, ctx.device)
        if self.ndim in KERNEL_AXES:
            return MBAExpr(self, dtype, lat, coords)
        shape = tuple(g + 3 for g in self.grids[0])
        return mba_device_eval(self.lo, self.hi, self.grids,
                               [lat.reshape(shape)], coords)
