"""Irregular SpMV: the CUDA kernels' wrappers and their plain versions.

Replaces the thirteen Pallas kernels of ``vexcl_tpu/sparse/shuffle.py``
that together compute ``SELLR.apply`` (expand x per slot, Benes routes
to width-class order and back, per-class column sums; the source of
``csrc/spmv_sell.cu`` says where each part of that work went).  Two
kernels in ``csrc/spmv_sell.cu``:

* ``sell_spmv``: SELL-C-sigma with C = 32, one thread per row, one warp
  per slice.  Slice s stores its column and value planes from
  ``slice_ptr[s]`` in packets of ``PACKET`` = 4 consecutive slots of a
  row: a (w_s / 4, 32, 4) plane, w_s a multiple of 4, so a lane loads a
  packet with one 16-byte load; padding slots have column -1; the thread
  of sorted row r writes ``y[perm[r]]`` (``perm`` None: r);
* ``csr_spmv``: CSR-Adaptive on row blocks (``row_blocks``): a block of
  short rows stages its products in shared memory and sums each row from
  there, a single long row is strided by the whole block; with ``rows``
  the k-th stored row is row ``rows[k]`` of y, and with ``out`` the
  result adds onto ``out`` (a second launch into the same y, for the
  hybrid tail and the SELL long rows).

Beside each, its plain PyTorch version on the same stored arrays: for
SELL a gather, a multiply and a sum per row over the slot axis, scattered
by ``perm``; for CSR an ``index_add_`` over row ids.  The wrappers run
the plain version for CPU tensors and the kernel for CUDA tensors with
(f32 values, f32 x) or (f64, f64); other pairs raise on CUDA.  Limits
that remain: columns, ``perm``, ``rows`` and the row-block boundaries
are int32, so n and m stay below 2^31; slot offsets and ``ptr`` are
int64, so nnz is not bounded by int32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .._build import written
from ..types import promote

__all__ = ["C", "PACKET", "ROW_BLOCK_ENTRIES", "ROW_BLOCK_ROWS", "row_blocks",
           "sell_spmv", "sell_spmv_plain", "csr_spmv", "csr_spmv_plain"]

#: rows per slice: one warp
C = 32

#: consecutive slots of a row that a SELL lane loads at once (16 bytes of
#: int32 columns); slice widths and offsets are multiples of it
PACKET = 4

#: a row block of the CSR kernel holds fewer entries than this (its
#: shared-memory product buffer, ``kBlockEntries`` in csrc/spmv_sell.cu)
#: and at most ``ROW_BLOCK_ROWS`` rows (its threads), or a single row
ROW_BLOCK_ENTRIES = 2048
ROW_BLOCK_ROWS = 256


def row_blocks(ptr: np.ndarray) -> np.ndarray:
    """The CSR kernel's row blocks: int32 boundaries ``b`` (nblocks + 1,
    from 0 to the row count) such that rows ``b[i]:b[i+1]`` form block i.

    One vectorised pass over ``ptr``: a block ends where a row starts in
    another window of ``w = ROW_BLOCK_ENTRIES // 2`` entries, around
    every row longer than ``w`` (which is then a block of its own), and
    every ``ROW_BLOCK_ROWS`` rows.  The rows of a multi-row block are at
    most w long and start inside one window, so they hold fewer than 2w
    entries."""
    ptr = np.asarray(ptr, dtype=np.int64)
    n = len(ptr) - 1
    w = ROW_BLOCK_ENTRIES // 2
    cut = np.zeros(n + 1, dtype=bool)
    cut[::ROW_BLOCK_ROWS] = True
    cut[n] = True
    start = ptr[:-1] // w
    cut[1:n] |= start[1:] != start[:-1]
    long = np.diff(ptr) > w
    cut[:n] |= long
    cut[1:] |= long
    return np.flatnonzero(cut).astype(np.int32)


_NAME = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_sell")
    if not getattr(lib, "_vex_bound", False):
        for t in _NAME.values():
            fn = getattr(lib, f"vex_sell_spmv_{t}")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"vex_csr_spmv_{t}")
            fn.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.vex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        lib._vex_bound = True
    return lib


def _check(kind: str, x: torch.Tensor, val: torch.Tensor, index_arrays):
    """Raise unless the kernel covers these operands; ``index_arrays``
    pairs each other operand (or None) with its required dtype."""
    if _NAME.get(val.dtype) is None or x.dtype != val.dtype:
        raise NotImplementedError(
            f"{kind} kernel has no form for {val.dtype} values with "
            f"{x.dtype} x")
    for t, dt in index_arrays:
        if t is not None and t.dtype != dt:
            raise ValueError(f"{kind}: operand of {t.dtype}, not {dt}")
    for t in [x, val] + [t for t, _ in index_arrays]:
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{kind} operands must be contiguous on one "
                             "device")


def _run(lib, entry: str, x: torch.Tensor, *args) -> None:
    """Launch ``entry`` on x's device and current stream; ``args`` are
    tensors (passed as pointers), None (null) or ints."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(*[a if isinstance(a, int) or a is None
                                   else a.data_ptr() for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())


def sell_spmv_plain(n: int, slice_ptr: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, perm: Optional[torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """The SELL kernel's plain version."""
    dt = promote(val.dtype, x.dtype)
    nslices = slice_ptr.shape[0] - 1
    slots = slice_ptr[1:] - slice_ptr[:-1]
    # sorted row of every slot: slice * C + the lane of its packet
    start = torch.repeat_interleave(slice_ptr[:-1], slots)
    sl = torch.repeat_interleave(torch.arange(nslices, device=x.device),
                                 slots)
    k = torch.arange(col.shape[0], device=x.device)
    row = sl * C + (k - start) // PACKET % C
    keep = col >= 0
    prod = torch.where(keep, val.to(dt) * x[col.clamp(min=0)].to(dt),
                       torch.zeros((), dtype=dt, device=x.device))
    ys = torch.zeros(nslices * C, dtype=dt, device=x.device)
    ys.index_add_(0, row, prod)
    if perm is None:
        return ys[:n].clone()
    y = torch.empty(n, dtype=dt, device=x.device)
    y[perm.long()] = ys[:n]
    return y


def sell_spmv(n: int, slice_ptr: torch.Tensor, col: torch.Tensor,
              val: torch.Tensor, perm: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """y (n) = the SELL planes times x."""
    if x.device.type == "cpu":
        return sell_spmv_plain(n, slice_ptr, col, val, perm, x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no SELL kernel for {x.device}")
    _check("SELL", x, val, [(slice_ptr, torch.int64), (col, torch.int32),
                           (perm, torch.int32)])
    if slice_ptr.shape[0] != -(-n // C) + 1:
        raise ValueError(f"SELL: {slice_ptr.shape[0] - 1} slices for {n} "
                         "rows")
    if (col.data_ptr() | val.data_ptr()) % 16:
        raise ValueError("SELL: col and val must be 16-byte aligned (the "
                         "kernel loads packets of 4 slots)")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    _run(_lib(), f"vex_sell_spmv_{_NAME[x.dtype]}", x, slice_ptr, col, val,
         perm, x, y, n)
    sell_spmv.launches += 1
    return y


def csr_spmv_plain(n: int, ptr: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, x: torch.Tensor,
                   rows: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CSR kernel's plain version."""
    dt = promote(val.dtype, x.dtype)
    nrows = ptr.shape[0] - 1
    rid = torch.repeat_interleave(torch.arange(nrows, device=x.device),
                                  ptr[1:] - ptr[:-1])
    if rows is not None:
        rid = rows.long()[rid]
    y = torch.zeros(n, dtype=dt, device=x.device) if out is None else out
    y.index_add_(0, rid, val.to(dt) * x[col.long()].to(dt))
    return y


def csr_spmv(n: int, ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor, rows: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None,
             blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (n) = the CSR rows times x; stored row k is row ``rows[k]`` of y
    (all rows when ``rows`` is None).  With ``out``, adds onto it.
    ``blocks``, the kernel's plan, is ``row_blocks(ptr)`` on x's device,
    as ``CSR`` keeps it; the kernel needs it, the plain version not."""
    if x.device.type == "cpu":
        return csr_spmv_plain(n, ptr, col, val, x, rows, out)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no CSR kernel for {x.device}")
    if blocks is None:
        raise ValueError("CSR: the kernel needs the row blocks of ptr "
                         "(row_blocks)")
    _check("CSR", x, val, [(ptr, torch.int64), (col, torch.int32),
                          (rows, torch.int32), (out, x.dtype),
                          (blocks, torch.int32)])
    nrows = ptr.shape[0] - 1
    if rows is None and nrows != n or out is not None and out.shape != (n,):
        raise ValueError(f"CSR: {nrows} stored rows for a result of {n}")
    if blocks.dim() != 1 or blocks.shape[0] < 1 + (nrows > 0):
        raise ValueError(f"CSR: row blocks of shape {tuple(blocks.shape)} "
                         f"for {nrows} rows")
    if out is not None:
        y = out
    else:
        y = (torch.empty if rows is None else torch.zeros)(
            n, dtype=x.dtype, device=x.device)
    if nrows == 0:
        return y
    _run(_lib(), f"vex_csr_spmv_{_NAME[x.dtype]}", x, ptr, col, val, blocks,
         rows, x, y, blocks.shape[0] - 1, int(out is not None))
    written(y)
    csr_spmv.launches += 1
    return y


#: launches of the CUDA kernels (not of the plain versions)
sell_spmv.launches = 0
csr_spmv.launches = 0
