"""Device sparse formats: CSR, ELL, hybrid ELL + CSR tail.

Port of ``vexcl_tpu/sparse/formats.py`` (vexcl/sparse/{csr,ell,matrix}.hpp,
vexcl/spmat/hybrid_ell.inl, csr.inl).  The JAX package keeps ELL as
row-major (n, width) planes for XLA's gather; here every ELL-family
format is stored as SELL-32 slices for the SELL kernel of
``cuda_sell.py``: slice s holds its 32 rows' column and value planes
from ``slice_ptr[s]`` as (w_s / 4, 32, 4) packets (packet k of lane l:
slots 4k .. 4k + 3 of row l), w_s rounded up to a multiple of 4;
padding slots carry column -1.

* ``CSR``: ptr (int64), col (int32), val and the row-block plan of the
  CSR kernel (``blocks``, int32).  With ``rows`` it holds a subset of the
  rows (the tails below).
* ``ELL``: SELL-32-1 at the global width, the longest row: rows keep
  their natural order.
* ``Hybrid``: that ELL part at the width of the reference's 3:1 rule
  (``choose_ell_width``, sparse/ell.hpp:92-121), plus a CSR tail of the
  overflow entries that the CSR kernel adds onto the ELL result.
* ``SELLR`` (``sell.py``): SELL-32-sigma, rows sorted by length.

Construction is vectorised numpy over the entries (no per-row loops and
no native helpers).  Duplicate (row, col) entries sum, empty rows give
0, and n != m works in every format.  Columns are int32, so n and m stay
below 2^31; offsets into the slots and ``ptr`` are int64.  The
``from_arrays`` constructors take a JAX package format's ``leaves()`` as
numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda_sell import C, PACKET, csr_spmv, row_blocks, sell_spmv

__all__ = ["CSR", "ELL", "Hybrid", "SlicedEll", "from_csr_host",
           "choose_ell_width", "check_csr"]


def _device(device) -> torch.device:
    if device is None:
        from ..context import current_context

        return current_context().device
    return torch.device(device)


def _to(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    from ..vector import host_tensor

    t = host_tensor(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def check_csr(n: int, m: int, ptr, col, val):
    """Host CSR arrays as numpy (ptr int64), checked: n + 1 monotone
    offsets from 0, columns in [0, m), n and m below 2^31."""
    if max(n, m) >= 2 ** 31:
        raise ValueError(f"{n}x{m} matrix: the kernels index rows and "
                         "columns in int32")
    ptr = np.asarray(ptr, dtype=np.int64)
    col = np.asarray(col)
    val = np.asarray(val)
    if ptr.shape != (n + 1,) or ptr[0] != 0 or np.any(np.diff(ptr) < 0):
        raise ValueError("ptr must hold n + 1 non-decreasing offsets from 0")
    nnz = int(ptr[-1])
    if len(col) < nnz or len(val) < nnz:
        raise ValueError(f"ptr counts {nnz} entries, col has {len(col)} and "
                         f"val {len(val)}")
    col, val = col[:nnz], val[:nnz]
    if nnz and (col.min() < 0 or col.max() >= m):
        raise ValueError(f"column index outside [0, {m})")
    return ptr, col, val


def choose_ell_width(row_len: np.ndarray) -> int:
    """Reference heuristic (sparse/ell.hpp:92-121): grow the ELL width
    while each added column stays 'worth it' (>= 1/3 of rows still have an
    entry in that column).  The JAX package's rule, unchanged."""
    if len(row_len) == 0:
        return 0
    max_w = int(row_len.max(initial=0))
    hist = np.bincount(row_len, minlength=max_w + 1)
    rows_with = len(row_len) - np.cumsum(hist)  # rows with len > w
    w = 0
    while w < max_w and rows_with[w] >= max(1, len(row_len) // 3):
        w += 1
    return w


class CSR:
    """Compressed sparse row (sparse/csr.hpp) on the row-block CSR kernel.

    ``rows`` (int32, optional) names the row of y that each stored row
    is; the stored rows are then a subset, as in a hybrid tail.
    ``blocks`` (int32) is the kernel's plan over the stored rows
    (``cuda_sell.row_blocks``), made once here."""

    format = "csr"

    def __init__(self, n: int, m: int, ptr, col, val, rows=None, *,
                 device=None):
        device = _device(device)
        self.n, self.m = int(n), int(m)
        ptr = np.asarray(ptr, dtype=np.int64)
        self.nnz = int(ptr[-1])
        self.ptr = _to(ptr, device)
        self.col = _to(np.asarray(col)[:self.nnz], device, torch.int32)
        self.val = _to(np.asarray(val)[:self.nnz], device)
        self.rows = None if rows is None else _to(rows, device, torch.int32)
        self.blocks = _to(row_blocks(ptr), device)

    @classmethod
    def from_arrays(cls, n: int, m: int, row_ids, col, val, *,
                    device=None) -> "CSR":
        """From a JAX package CSR's leaves (row_ids, col, val)."""
        counts = np.bincount(np.asarray(row_ids, dtype=np.int64),
                             minlength=n)
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        return cls(n, m, ptr, col, val, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    def apply(self, x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y = A x (with ``out``: out += A x)."""
        return csr_spmv(self.n, self.ptr, self.col, self.val, x, self.rows,
                        out, self.blocks)


def _tail(n: int, m: int, row: np.ndarray, drop: np.ndarray, col, val,
          device) -> Optional[CSR]:
    """The entries ``drop`` (grouped by ascending ``row``, as CSR order
    keeps them) as a CSR over the rows that have any."""
    if not drop.any():
        return None
    counts = np.bincount(row[drop], minlength=n)
    rows = np.flatnonzero(counts)
    ptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(counts[rows], out=ptr[1:])
    return CSR(n, m, ptr, col[drop], val[drop], rows=rows, device=device)


class SlicedEll:
    """SELL-32 slices of an ELL-family format, plus an optional CSR tail
    that adds onto the slices' result.

    ``slice_ptr`` (int64, nslices + 1) gives each slice's first slot, a
    multiple of ``PACKET``; ``perm`` (int32 or None) maps the kernel's
    row order to the natural one.  Subclasses choose the stored lengths,
    the order and the width.
    """

    def _pack(self, n: int, m: int, ptr: np.ndarray, col: np.ndarray,
              val: np.ndarray, lens: np.ndarray, order: Optional[np.ndarray],
              width: Optional[int], device) -> None:
        """Store the first ``lens[i]`` entries of each row i in SELL-32
        slices (rows in kernel order ``order``, natural order if None;
        every slice ``width`` wide if given, else as wide as its longest
        row; widths rounded up to a multiple of ``PACKET``) and the other
        entries in the CSR tail."""
        device = _device(device)
        self.n, self.m = int(n), int(m)
        self.nnz = int(ptr[-1])
        nslices = -(-self.n // C)
        if width is None:
            kl = np.zeros(nslices * C, dtype=np.int64)
            kl[:self.n] = lens if order is None else lens[order]
            w = kl.reshape(nslices, C).max(axis=1, initial=0)
        else:
            w = np.full(nslices, int(width), dtype=np.int64)
        w = -(-w // PACKET) * PACKET
        slice_ptr = np.zeros(nslices + 1, dtype=np.int64)
        np.cumsum(w * C, out=slice_ptr[1:])
        nslots = int(slice_ptr[-1])
        # every entry: its row and its place in the row
        row = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(ptr))
        j = np.arange(self.nnz, dtype=np.int64) - ptr[row]
        keep = j < lens[row]
        if order is None:
            p = row[keep]
        else:
            pos = np.empty(self.n, dtype=np.int64)
            pos[order] = np.arange(self.n)
            p = pos[row[keep]]
        j = j[keep]
        dst = (slice_ptr[p // C] + j // PACKET * (PACKET * C)
               + p % C * PACKET + j % PACKET)
        del p, j
        pcol = np.full(nslots, -1, dtype=np.int32)
        pcol[dst] = col[keep]
        pval = np.zeros(nslots, dtype=val.dtype)
        pval[dst] = val[keep]
        del dst
        self._store(slice_ptr, pcol, pval, order,
                    _tail(self.n, self.m, row, ~keep, col, val, device),
                    device)

    def _store(self, slice_ptr, pcol, pval, order, tail, device) -> None:
        self.slice_ptr = _to(slice_ptr, device)
        self.col = _to(pcol, device, torch.int32)
        self.val = _to(pval, device)
        self.perm = None if order is None else _to(order, device, torch.int32)
        self.tail = tail

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def slots(self) -> int:
        """Stored slots, padding included (tail entries not counted)."""
        return int(self.col.shape[0])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x: the SELL kernel, then the tail's CSR kernel into the
        same y."""
        y = sell_spmv(self.n, self.slice_ptr, self.col, self.val, self.perm,
                      x)
        if self.tail is not None:
            self.tail.apply(x, out=y)
        return y


def _from_rowmajor(obj: SlicedEll, n: int, m: int, ell_col, ell_val,
                   tail: Optional[CSR], device) -> None:
    """Slices from row-major (n, w) ELL planes (the JAX package's)."""
    ell_col = np.asarray(ell_col).reshape(n, -1)
    ell_val = np.asarray(ell_val).reshape(n, -1)
    w = ell_col.shape[1]
    w4 = -(-w // PACKET) * PACKET
    nslices = -(-n // C)
    pc = np.full((nslices * C, w4), -1, dtype=np.int32)
    pc[:n, :w] = ell_col
    pv = np.zeros((nslices * C, w4), dtype=ell_val.dtype)
    pv[:n, :w] = ell_val

    def packets(a):        # (row, slot) -> (slice, packet, lane, 4)
        return a.reshape(nslices, C, w4 // PACKET, PACKET).transpose(
            0, 2, 1, 3).ravel()
    obj.n, obj.m, obj.width = int(n), int(m), w
    obj.nnz = int(np.count_nonzero(ell_col >= 0)) + (tail.nnz if tail else 0)
    obj._store(np.arange(nslices + 1, dtype=np.int64) * C * w4,
               packets(pc), packets(pv), None, tail, _device(device))


class ELL(SlicedEll):
    """Padded ELLPACK (sparse/ell.hpp): SELL-32-1 at the width of the
    longest row, rows in natural order, no tail."""

    format = "ell"

    def __init__(self, n: int, m: int, ptr, col, val, *, device=None):
        ptr, col, val = check_csr(n, m, ptr, col, val)
        lens = np.diff(ptr)
        self.width = int(lens.max(initial=0))
        self._pack(n, m, ptr, col, val, lens, None, self.width, device)

    @classmethod
    def from_arrays(cls, n: int, m: int, ell_col, ell_val, *,
                    device=None) -> "ELL":
        """From a JAX package ELL's leaves: (n, w) col (-1 padded), val."""
        obj = cls.__new__(cls)
        _from_rowmajor(obj, n, m, ell_col, ell_val, None, device)
        return obj


class Hybrid(SlicedEll):
    """ELL + CSR tail (spmat/hybrid_ell.inl): the ELL part is SELL-32-1 at
    ``choose_ell_width``; each row's entries beyond it go to the tail."""

    format = "hyb"

    def __init__(self, n: int, m: int, ptr, col, val, *, device=None):
        ptr, col, val = check_csr(n, m, ptr, col, val)
        lens = np.diff(ptr)
        self.width = choose_ell_width(lens)
        self._pack(n, m, ptr, col, val, np.minimum(lens, self.width), None,
                   self.width, device)

    @classmethod
    def from_arrays(cls, n: int, m: int, ell_col, ell_val, tail_row_ids=None,
                    tail_col=None, tail_val=None, *, device=None) -> "Hybrid":
        """From a JAX package Hybrid's leaves: the ELL planes, then the
        tail CSR's (row_ids, col, val) if it has one."""
        tail = None
        if tail_row_ids is not None and len(tail_row_ids):
            row = np.asarray(tail_row_ids, dtype=np.int64)
            tail = _tail(n, m, row, np.ones(len(row), dtype=bool),
                         np.asarray(tail_col), np.asarray(tail_val),
                         _device(device))
        obj = cls.__new__(cls)
        _from_rowmajor(obj, n, m, ell_col, ell_val, tail, device)
        return obj


def from_csr_host(n: int, m: int, ptr, col, val, fmt: str = "hyb", *,
                  device=None):
    """Build a device format (``csr``, ``ell``, ``hyb`` or ``sellr``)
    from host CSR arrays."""
    if fmt == "csr":
        ptr, col, val = check_csr(n, m, ptr, col, val)
        return CSR(n, m, ptr, col, val, device=device)
    if fmt == "ell":
        return ELL(n, m, ptr, col, val, device=device)
    if fmt == "hyb":
        return Hybrid(n, m, ptr, col, val, device=device)
    if fmt == "sellr":
        from .sell import SELLR

        return SELLR(n, m, ptr, col, val, device=device)
    raise ValueError(f"unknown sparse format {fmt!r}")
