"""cuFFT through ctypes: the transform of ``ops/fft.py``'s ``Plan`` run
into a tensor the caller gives, on the card.

``torch.fft.fftn(x, out=y)`` computes into a temporary and copies it into
``y`` (92.6 µs of the API's 0.3700 ms at 2^24 c64 on an H100, PERF.md
§6), so the FFT API, which writes into its target vector, runs cuFFT
itself: the library PyTorch ships and has loaded (found among the
process's loaded libraries, never another copy), a plan a
(``Plan``, device, stream) made at the first call with its work area
from PyTorch's allocator, executed on PyTorch's current stream straight
into the target's storage.  The JAX package calls XLA's FFT HLO here,
not a Pallas kernel, so a library transform stands where XLA's stood, as
``torch.fft`` does.  An inverse is scaled by 1/n afterwards in place, as
``torch.fft.ifftn`` scales its result.

``layout(shape, dims)`` says whether one cuFFT plan covers a transform:
at most three transformed axes that are the leading or the trailing ones
of the shape (the others a batch); ``Plan`` keeps ``torch.fft`` for the
rest.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import written
from .cuda_scatter import _on

__all__ = ["layout", "execute"]

_C2C, _Z2Z = 0x29, 0x69          # cufftType
_FORWARD, _INVERSE = -1, 1       # cufftExec* direction
#: sonames of cuFFT, newest first (CUDA 13, 12, 11)
_SONAMES = ("libcufft.so.12", "libcufft.so.11", "libcufft.so.10")

_lib: Optional[ctypes.CDLL] = None


def layout(shape: Sequence[int], dims: Sequence[int]
           ) -> Optional[Tuple[Tuple[int, ...], int, int, int]]:
    """(the transformed sizes, the batch, the stride of an element and the
    distance between batch members) of one cuFFT plan over ``dims`` of a
    row-major ``shape``, or None where one plan does not cover it."""
    dims = sorted(dims)
    if not 1 <= len(dims) <= 3 or dims != list(range(dims[0], dims[-1] + 1)):
        return None
    sizes = tuple(shape[d] for d in dims)
    before = int(np.prod(shape[:dims[0]], dtype=np.int64))
    after = int(np.prod(shape[dims[-1] + 1:], dtype=np.int64))
    if after == 1:      # trailing axes: batch members one after another
        return sizes, before, 1, int(np.prod(sizes, dtype=np.int64))
    if before == 1:     # leading axes: batch members interleaved
        return sizes, after, after, 1
    return None


def _library() -> ctypes.CDLL:
    """PyTorch's own cuFFT, already loaded in this process."""
    global _lib
    if _lib is not None:
        return _lib
    for attempt in range(2):
        for name in _SONAMES:
            try:
                lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_GLOBAL)
            except OSError:
                continue
            _bind(lib)
            _lib = lib
            return lib
        if attempt == 0:
            # PyTorch loads cuFFT with its first transform on the card
            torch.fft.fft(torch.zeros(2, dtype=torch.complex64,
                                      device="cuda"))
    raise RuntimeError("cuFFT is not loaded in this process: PyTorch "
                       f"loaded none of {', '.join(_SONAMES)}")


def _bind(lib: ctypes.CDLL) -> None:
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    ip = ctypes.POINTER(ctypes.c_int)
    lib.cufftCreate.argtypes = [ip]
    lib.cufftSetAutoAllocation.argtypes = [i32, i32]
    lib.cufftMakePlanMany.argtypes = [i32, i32, ip, ip, i32, i32, ip, i32,
                                      i32, i32, i32,
                                      ctypes.POINTER(ctypes.c_size_t)]
    lib.cufftSetWorkArea.argtypes = [i32, ptr]
    lib.cufftSetStream.argtypes = [i32, ptr]
    for f in (lib.cufftExecC2C, lib.cufftExecZ2Z):
        f.argtypes = [i32, ptr, ptr, i32]
    for f in (lib.cufftCreate, lib.cufftSetAutoAllocation,
              lib.cufftMakePlanMany, lib.cufftSetWorkArea,
              lib.cufftSetStream, lib.cufftExecC2C, lib.cufftExecZ2Z):
        f.restype = i32


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"cuFFT {what} failed: cufftResult {rc}")


class _Entry:
    """A cuFFT plan on one device and stream, with its work area."""

    __slots__ = ("handle", "work", "exec", "scale")

    def __init__(self, plan, geometry, device: torch.device, stream: int):
        lib = _library()
        sizes, batch, stride, dist = geometry
        h = ctypes.c_int()
        with torch.cuda.device(device):
            _check(lib.cufftCreate(ctypes.byref(h)), "cufftCreate")
            _check(lib.cufftSetAutoAllocation(h.value, 0),
                   "cufftSetAutoAllocation")
            n = (ctypes.c_int * len(sizes))(*sizes)
            work = ctypes.c_size_t()
            double = plan.dtype == torch.complex128
            _check(lib.cufftMakePlanMany(
                h.value, len(sizes), n, n, stride, dist, n, stride, dist,
                _Z2Z if double else _C2C, batch, ctypes.byref(work)),
                "cufftMakePlanMany")
            self.work = torch.empty(max(1, work.value), dtype=torch.uint8,
                                    device=device)
            _check(lib.cufftSetWorkArea(h.value, self.work.data_ptr()),
                   "cufftSetWorkArea")
            _check(lib.cufftSetStream(h.value, stream), "cufftSetStream")
        self.handle = h.value
        self.exec = lib.cufftExecZ2Z if double else lib.cufftExecC2C
        self.scale = (1.0 / int(np.prod(sizes, dtype=np.int64))
                      if plan.inverse else None)


def execute(plan, x: torch.Tensor, out: torch.Tensor) -> None:
    """The transform of ``plan`` of ``x`` (contiguous, of the plan's type
    and size, on a CUDA device) written into ``out`` (the same), on the
    current stream."""
    dev = out.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    cache: Dict[tuple, _Entry] = plan.cufft
    e = cache.get((dev.index, stream))
    if e is None:
        e = cache[(dev.index, stream)] = _Entry(plan, plan.cufft_layout,
                                                dev, stream)
    _check(_on(dev, e.exec, (e.handle, x.data_ptr(), out.data_ptr(),
                             _INVERSE if plan.inverse else _FORWARD)),
           "exec")
    written(out)
    execute.launches += 1
    if e.scale is not None:
        out.mul_(e.scale)


#: cuFFT executions (``chip_smoke.py`` counts the API's)
execute.launches = 0
