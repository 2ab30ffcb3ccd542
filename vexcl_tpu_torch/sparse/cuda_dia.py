"""DIA SpMV: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the three kernels of ``vexcl_tpu/sparse/pallas_dia.py``:
``_kernel`` (``dia_matvec_pallas``, the window kernel that Poisson 256^3
takes), ``_roll_kernel`` (``dia_matvec_pallas_roll``, Poisson 64^3) and
``_ring_kernel`` (``dia_matvec_pallas_ring``, opt-in there through
VEXTPU_DIA_RING; the switch is not ported).  One kernel,
``csrc/dia_spmv.cu``, computes what all three compute: one thread per
row, coalesced tap loads, bounds-checked columns (the source says why
the halo stays out of shared memory).

``dia_matvec`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors, for the plane/x type pairs (bf16, f32),
(f32, f32) and (f64, f64); other pairs raise on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .._build import written

__all__ = ["dia_matvec", "dia_matvec_plain", "result_dtype"]

_ENTRY = {
    (torch.bfloat16, torch.float32): "vex_dia_spmv_bf16_f32",
    (torch.float32, torch.float32): "vex_dia_spmv_f32_f32",
    (torch.float64, torch.float64): "vex_dia_spmv_f64_f64",
}


def result_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    """bf16 planes compute in x's type (they are compressed f32 planes);
    otherwise the promoted type, as in the JAX package's DIA.matvec."""
    if vals_dtype == torch.bfloat16:
        return x_dtype
    return torch.promote_types(vals_dtype, x_dtype)


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_dia")
    if not getattr(lib, "_vex_bound", False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.vex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        lib._vex_bound = True
    return lib


def dia_matvec_plain(n: int, m: int, offsets: Sequence[int],
                     vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x by shifted slices: each diagonal multiplies the in-range
    window of x (the JAX package's XLA form, without the padded copy)."""
    dt = result_dtype(vals.dtype, x.dtype)
    y = torch.zeros(n, dtype=dt, device=x.device)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if lo < hi:
            y[lo:hi] += vals[k, lo:hi].to(dt) * x[lo + off: hi + off].to(dt)
    return y


def dia_matvec(n: int, m: int, offsets: Sequence[int],
               offsets_dev: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A x for DIA planes ``vals`` (d, n) at ``offsets``; x has m
    elements.  ``offsets_dev`` is the same offsets as an int64 tensor on
    x's device.  With ``out`` (n contiguous elements of y's type, not
    x's memory), y is written there."""
    if x.device.type == "cpu":
        y = dia_matvec_plain(n, m, offsets, vals, x)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no DIA kernel for {x.device}")
    d = len(offsets)
    if not d:
        y = torch.zeros(n, dtype=result_dtype(vals.dtype, x.dtype),
                        device=x.device)
        return y if out is None else out.copy_(y)
    entry = _ENTRY.get((vals.dtype, x.dtype))
    if entry is None:
        raise NotImplementedError(
            f"DIA kernel has no form for {vals.dtype} planes with "
            f"{x.dtype} x")
    if x.shape != (m,) or vals.shape != (d, n):
        raise ValueError(f"DIA shapes: vals {tuple(vals.shape)}, x "
                         f"{tuple(x.shape)} for a {n}x{m} matrix with {d} "
                         "diagonals")
    for t in (vals, x, offsets_dev):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("DIA operands must be contiguous on one device")
    if offsets_dev.dtype != torch.int64 or offsets_dev.shape != (d,):
        raise ValueError("offsets_dev must be a (d,) int64 tensor")
    if out is None:
        y = torch.empty(n, dtype=x.dtype, device=x.device)
    elif (out.shape != (n,) or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError(f"DIA output: {n} contiguous {x.dtype} elements on "
                         f"{x.device}")
    else:
        y = out
    if n == 0:
        return y
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(offsets_dev.data_ptr(), vals.data_ptr(),
                                 x.data_ptr(), y.data_ptr(), n, m, d, stream)
    if rc != 0:
        raise RuntimeError("DIA kernel launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())
    written(y)
    dia_matvec.launches += 1
    return y


#: launches of the CUDA kernel (not of the plain version)
dia_matvec.launches = 0
