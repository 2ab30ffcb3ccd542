"""MBA's tap sum: the CUDA kernel's wrapper, its tables and its plain
PyTorch version.

Replaces the tap sum of V1's generated Triton kernel (the interpolant as
an elementwise tree of 4^d ``PointerDeref`` loads, ``ops/mba.py``'s
``mba_device_eval``), which stands where the JAX package has XLA's
gathers (``vexcl_tpu/ops/mba.py:164-208``).  The kernel,
``csrc/mba.cu`` (its source note gives the design and bound), evaluates
``mba`` interpolants of d = 1, 2 and 3 axes in f32 and f64 with the
tree's arithmetic in the tree's order, one launch a call of
``mba_eval(out, coords, lattice, lo, hi, grid)``; an interpolant of more
axes keeps the tree (``mba.__call__`` routes by d).

The kernel reads the control lattice from a table whose layout is tied to
the type (``table``), the faster at the bench's fit (2^24 points of a
259^2 lattice) on an H100 80GB HBM3 at 700 W (PERF.md §6): in f32 the
lattice itself (381 µs of device time against the 4x table's 486: its
1.07 MB leaves the L1 for the L2), in f64 a 4x table whose entry j holds
the four controls from j along the last axis (569 against the lattice's
800: the 537 KB lattice no longer fits the L1 either, and one 32-byte
sector a row is the fewest).  Two other layouts measured no faster in
either type and were not kept (``csrc/mba.cu``'s note).

On a CPU tensor the wrapper runs the plain version, ``mba_plain``: the
tree's plain PyTorch form over the lattice; on a CUDA tensor the kernel
launches or the call raises.  ``mba_eval.launches`` counts the calls that
launched.  Tolerance of the kernel against the plain version on the
card: the same operations in the same order, so equal up to the
library's division and floor (f32 relative 1e-5, f64 1e-12 of the
largest magnitude, as ``chip_smoke.py`` and the card tests state).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .._build import written
from .cuda_scatter import _on, _raise

__all__ = ["table", "mba_eval", "mba_plain"]

#: the most table entries the kernel indexes (32-bit entry indices)
MAX_ENTRIES = (1 << 31) - 1


def table(lattice: torch.Tensor) -> torch.Tensor:
    """The kernel's flat table of ``lattice``, a (g + 3)^d tensor, on its
    device and in its type: f32 the lattice itself, f64 four entries a
    control (the module docstring)."""
    flat = lattice.reshape(-1).contiguous()
    if flat.dtype != torch.float64:
        return flat
    j = torch.arange(flat.numel(), device=flat.device)
    at = torch.clamp(j[:, None] + torch.arange(4, device=flat.device),
                     max=flat.numel() - 1)
    # entries whose row runs past the end of the last axis are never a tap
    # box's base (its base index is at most grid - 1)
    return flat[at].reshape(-1)


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_mba")
    if not getattr(lib, "_vex_bound", False):
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.vex_mba_eval.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ptr, ctypes.c_int64,
            f64, f64, f64, f64, f64, f64, i32, i32, i32, ptr]
        lib.vex_mba_eval.restype = i32
        lib.vex_cuda_error_string.argtypes = [i32]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        lib._vex_bound = True
    return lib


def _check(out: torch.Tensor, coords: Sequence[torch.Tensor],
           grid: Sequence[int]) -> None:
    d = len(grid)
    if not 1 <= d <= 3 or len(coords) != d:
        raise NotImplementedError(f"the MBA kernel takes 1-3 axes, not {d}")
    if out.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"no MBA kernel for {out.dtype}")
    for c in (out, *coords):
        if c.dtype != out.dtype or c.ndim != 1 or not c.is_contiguous() \
                or c.shape != out.shape or c.device != out.device:
            raise ValueError("mba_eval: contiguous 1-D coordinates of the "
                             "output's type, length and device")


def mba_eval(out: torch.Tensor, coords: Sequence[torch.Tensor],
             lattice: torch.Tensor, lo: Sequence[float], hi: Sequence[float],
             grid: Sequence[int], tab: Optional[torch.Tensor] = None
             ) -> None:
    """``out[i]`` = the interpolant of the control ``lattice`` ((g + 3)^d,
    on the card in ``out``'s type) over the domain ``lo``-``hi`` cut in
    ``grid`` cells at the point ``coords[.][i]``; on CUDA through ``tab``
    (``table(lattice)``, built here when not given)."""
    _check(out, coords, grid)
    if out.device.type == "cpu":
        mba_plain(out, coords, lattice, lo, hi, grid)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no MBA kernel for {out.device}")
    if out.numel() == 0:
        return
    tab = tab if tab is not None else table(lattice)
    if tab.dtype != out.dtype or tab.device != out.device \
            or tab.numel() > MAX_ENTRIES:
        raise ValueError("mba_eval: a table of the output's type and "
                         "device, of fewer than 2^31 entries")
    d = len(grid)
    x = [c.data_ptr() for c in coords] + [None] * (3 - d)
    h = [(hi[k] - lo[k]) / grid[k] for k in range(d)] + [1.0] * (3 - d)
    lo3 = list(lo) + [0.0] * (3 - d)
    g3 = list(grid) + [1] * (3 - d)
    dev = out.device
    args = (int(out.dtype == torch.float64), d, *x,
            tab.data_ptr(), out.data_ptr(), out.numel(), *lo3, *h, *g3,
            torch._C._cuda_getCurrentRawStream(dev.index))
    lib = _lib()
    _raise(lib, _on(dev, lib.vex_mba_eval, args), "mba_eval")
    written(out)
    mba_eval.launches += 1


#: calls that launched the kernel (not of the plain version)
mba_eval.launches = 0


def mba_plain(out: torch.Tensor, coords: Sequence[torch.Tensor],
              lattice: torch.Tensor, lo: Sequence[float],
              hi: Sequence[float], grid: Sequence[int]) -> None:
    """The kernel's plain PyTorch version: the interpolant's elementwise
    tree (``mba_device_eval``) evaluated by its plain form on ``out``'s
    device, the taps summed in the kernel's order."""
    from ..expr.compile import prepare
    from ..expr.node import ArrayTerminal
    from ..expr.triton_emit import assign_plain
    from .mba import mba_device_eval

    shape = tuple(g + 3 for g in grid)
    expr = mba_device_eval(tuple(lo), tuple(hi), [tuple(grid)],
                           [lattice.reshape(shape)],
                           [ArrayTerminal(c) for c in coords])
    e, analysis, types, leaves = prepare(expr, out.numel(), out.device)
    assign_plain(e, analysis, types, leaves, out)
