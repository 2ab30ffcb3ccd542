"""DIA (diagonal) sparse format for banded matrices.

Port of ``vexcl_tpu/sparse/dia.py``.  Matrices from regular grids — the
reference's own 7-point Poisson benchmark (examples/benchmark.cpp:353-478)
among them — are a few dense diagonals, and their SpMV is shifted reads
and multiply-adds with no column indices.  ``SpMat(..., fmt=None)`` picks
DIA when the structure fits (``try_build_dia``).

Layout: ``offsets`` (d,) ints; ``vals`` (d, n) — vals[k, i] is A[i, i +
offsets[k]] (zero where out of range).  f32 planes whose values bf16 holds
exactly are stored as ``torch.bfloat16`` (dia.py:35-46): half the
dominant memory stream of the SpMV, bit-identical products, computed in
f32.  ``dtype`` stays the logical value type (f32), so solvers built on
the matrix work in f32.  (The JAX package reports the plane type, bf16,
and its f32 PoissonSolver therefore solves in bf16.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda_dia import dia_matvec, result_dtype

__all__ = ["DIA", "try_build_dia"]


def _bf16_exact(t: torch.Tensor) -> bool:
    return bool(torch.equal(t.to(torch.bfloat16).to(torch.float32), t))


class DIA:
    format = "dia"

    def __init__(self, n: int, m: int, offsets, vals, *, device=None,
                 compress: bool = True):
        from ..vector import host_tensor

        self.n = int(n)
        self.m = int(m)
        self.offsets = tuple(int(o) for o in offsets)
        t = host_tensor(vals).reshape(len(self.offsets), self.n)
        self.value_dtype = (torch.float32 if t.dtype == torch.bfloat16
                            else t.dtype)
        if compress and t.dtype == torch.float32 and _bf16_exact(t):
            t = t.to(torch.bfloat16)
        if device is None:
            from ..context import current_context

            device = current_context().device
        self.vals = t.to(device).contiguous()
        self.offsets_dev = torch.tensor(self.offsets, dtype=torch.int64,
                                        device=device)
        #: the planes' real and imaginary parts, tensors that a copy onto
        #: another device moves (``by_real_parts``)
        self._re = self._im = None
        self.nnz = int(torch.count_nonzero(self.vals))

    @classmethod
    def from_arrays(cls, n: int, m: int, offsets, vals, *,
                    device=None) -> "DIA":
        """A DIA matrix from given planes, e.g. a JAX package DIA's
        ``offsets`` and ``np.asarray(vals)``; bf16 planes stay bf16 and
        no other compression is applied."""
        return cls(n, m, offsets, vals, device=device, compress=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.value_dtype

    def result_dtype(self, x_dtype: torch.dtype) -> torch.dtype:
        return result_dtype(self.vals.dtype, x_dtype)

    def apply(self, x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = A x (the DIA kernel on CUDA, its plain version on CPU),
        into ``out`` where it is given (``dia_matvec``).  Complex planes
        or x on CUDA go through ``by_real_parts``."""
        if x.device.type == "cuda" and (self.vals.is_complex()
                                        or x.is_complex()):
            y = self.by_real_parts(x)
            return y if out is None else out.copy_(y)
        return dia_matvec(self.n, self.m, self.offsets, self.offsets_dev,
                          self.vals, x, out)

    def by_real_parts(self, x: torch.Tensor) -> torch.Tensor:
        """A x of complex planes or a complex x by the real kernel (the
        kernel has no complex form): (Ar + i Ai)(xr + i xi) as
        Ar xr - Ai xi + i (Ar xi + Ai xr), one DIA launch a product of
        nonzero parts (four at most), the planes' parts made contiguous
        once."""
        if self._re is None:
            v = self.vals
            self._re, self._im = ((v.real.contiguous(), v.imag.contiguous())
                                  if v.is_complex() else (v, None))
        ar, ai = self._re, self._im
        xr, xi = ((x.real.contiguous(), x.imag.contiguous())
                  if x.is_complex() else (x, None))

        def mv(a, v):
            return dia_matvec(self.n, self.m, self.offsets,
                              self.offsets_dev, a, v)

        re = [mv(ar, xr)] + ([-mv(ai, xi)] if ai is not None
                             and xi is not None else [])
        im = ([mv(ar, xi)] if xi is not None else []) + (
            [mv(ai, xr)] if ai is not None else [])
        return torch.complex(sum(re[1:], re[0]), sum(im[1:], im[0]))


def try_build_dia(n: int, m: int, ptr: np.ndarray, col: np.ndarray,
                  val: np.ndarray, max_diags: int = 32,
                  min_fill: float = 0.25, *, device=None) -> Optional[DIA]:
    """Build DIA if the matrix is diagonal-structured: at most
    ``max_diags`` distinct diagonals, each at least ``min_fill`` occupied
    on average.  Returns None when the structure does not fit."""
    ptr = np.asarray(ptr, dtype=np.int64)
    col = np.asarray(col)
    val = np.asarray(val)
    nnz = int(ptr[-1])
    if nnz == 0:
        return None
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    offs = col.astype(np.int64) - rows
    # presence-table unique: O(nnz), no sort.  Offsets span [-(n-1), m-1],
    # so bias by n to index the (n+m+1)-entry table.
    base = np.int64(n)
    present = np.zeros(n + m + 1, dtype=bool)
    present[offs + base] = True
    uniq = np.flatnonzero(present) - base
    if len(uniq) > max_diags:
        return None
    if nnz < min_fill * len(uniq) * n:
        return None
    lookup = np.cumsum(present) - 1
    k_idx = lookup[offs + base]
    pos = k_idx * np.int64(n) + rows
    del rows, offs, k_idx
    size = len(uniq) * n
    flat = np.zeros(size, dtype=val.dtype)
    seen = np.zeros(size, dtype=bool)
    seen[pos] = True
    if int(seen.sum()) == len(pos):
        flat[pos] = val          # duplicate-free: one cell per entry
    else:
        np.add.at(flat, pos, val)  # duplicates sum (CSR semantics)
    return DIA(n, m, uniq, flat.reshape(len(uniq), n), device=device)
