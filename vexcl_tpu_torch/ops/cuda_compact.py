"""Stream compaction: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces ``vexcl_tpu/ops/pallas_compact.py::_compact_kernel``
(``pallas_compact``) and the compaction half of
``pallas_rbk.py::_fused_kernel`` (``pallas_segscan_rowcompact``).  Those
compact within a block by lane rolls and leave the assembly of the
blocks to a sort; the kernel, ``csrc/compact.cu``, is one single-pass
launch with decoupled look-back that scatters each flagged element to
its global slot directly (its source note gives the design and bound).

``compact_apply(flags, *payloads) -> (count, *compacted)``: ``flags`` is
a u8 or bool tensor (any contiguous view: the kernel reads an unaligned
start itself); each payload is a tensor of its length with 1-, 2-, 4- or
8-byte elements (at most eight of them), moved bit for bit.  ``count``
is a 0-d int64 tensor on the device, and each compacted tensor has the
payload's length: its first ``count`` entries are the payload's flagged
elements in their original order, the rest is undefined.  On a CPU
tensor the plain version runs; on a CUDA tensor the kernel launches.

The kernel's scratch (a status word per tile and two counters, left
zeroed by every launch) is kept per (device, stream) by
``cuda_scratch.StreamScratch``.  A call allocates its outputs and the 0-d
count, nothing else, and launches once.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_scratch import StreamScratch

__all__ = ["compact_apply", "compact_plain", "MAX_PAYLOADS"]

#: payloads one launch moves (csrc/compact.cu ``kMaxPayloads``)
MAX_PAYLOADS = 8

#: status words allocated at least (one per tile of 32768 flags: 2^27)
_MIN_TILES = 4096

_LOG2 = {1: 0, 2: 1, 4: 2, 8: 3}
_FLAG_TYPES = (torch.uint8, torch.bool)


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_compact")
    if not getattr(lib, "_vex_bound", False):
        lib.vex_compact.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.vex_compact.restype = ctypes.c_int
        lib.vex_compact_tile.restype = ctypes.c_int
        lib.vex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        lib.tile = lib.vex_compact_tile()
        lib._vex_bound = True
    return lib


#: the status words (one a tile) and counters of each (device, stream)
_scratch = StreamScratch(1, _MIN_TILES)


def compact_plain(flags: torch.Tensor,
                  *payloads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Boolean-mask selection; the entries past ``count`` are zero."""
    mask = flags.to(device=flags.device, dtype=torch.bool)
    count = mask.sum(dtype=torch.int64)
    outs = []
    for p in payloads:
        o = torch.zeros_like(p)
        sel = p[mask]
        o[:sel.shape[0]] = sel
        outs.append(o)
    return (count, *outs)


def compact_apply(flags: torch.Tensor,
                  *payloads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(count, *compacted): the payloads' elements at the nonzero flags,
    packed in order (see the module docstring)."""
    n = flags.shape[0]
    if flags.ndim != 1 or any(p.shape != flags.shape for p in payloads):
        raise ValueError("compaction: flags and payloads must be 1-D tensors "
                         "of one length")
    device = flags.device
    if device.type == "cpu":
        return compact_plain(flags, *payloads)
    if device.type != "cuda":
        raise NotImplementedError(f"no compaction kernel for {device}")
    if flags.dtype not in _FLAG_TYPES:
        raise NotImplementedError(f"compaction kernel takes u8 or bool "
                                  f"flags, not {flags.dtype}")
    k = len(payloads)
    if k > MAX_PAYLOADS:
        raise NotImplementedError(f"compaction kernel moves at most "
                                  f"{MAX_PAYLOADS} payloads")
    codes = 0
    for q, p in enumerate(payloads):
        code = _LOG2.get(p.element_size())
        if code is None:
            raise NotImplementedError(f"compaction kernel has no form for "
                                      f"{p.element_size()}-byte {p.dtype}")
        codes |= code << (2 * q)
    if not all(t.device == device and t.is_contiguous()
               for t in (flags, *payloads)):
        raise ValueError("compaction operands must be contiguous on one "
                         "device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _lib()
    # the raw stream handle (~0.1 us; a Stream object costs ~3 us)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    status, counters = _scratch.get(device, stream,
                                    max(1, -(-(n + 15) // lib.tile)))
    outs = [torch.empty_like(p) for p in payloads]
    count = torch.empty((), dtype=torch.int64, device=device)
    ptrs = (ctypes.c_void_p * max(2 * k, 1))(
        *[t.data_ptr() for t in (*payloads, *outs)])
    args = (flags.data_ptr(), n, k, codes, ptrs, count.data_ptr(),
            status.data_ptr(), counters.data_ptr(), stream)
    if torch.cuda.current_device() == device.index:
        rc = lib.vex_compact(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.vex_compact(*args)
    if rc != 0:
        raise RuntimeError("compaction kernel launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())
    compact_apply.launches += 1
    return (count, *outs)


#: launches of the CUDA kernel (not of the plain version)
compact_apply.launches = 0
