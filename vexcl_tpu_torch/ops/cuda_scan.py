"""Inclusive scans, plain and segmented: the CUDA kernel's wrappers and
their plain PyTorch versions.

Replaces ``vexcl_tpu/ops/pallas_scan.py::_scan_kernel`` (``pallas_cumsum``),
``pallas_monoid_scan.py::_mono_kernel`` (``pallas_cummax``,
``pallas_cummin``), ``pallas_segscan.py::_seg_kernel``
(``pallas_segmented_cumsum_flags``, ``pallas_segmented_cumsum``) and the
scan half of ``pallas_rbk.py::_fused_kernel``.  The kernel,
``csrc/scan.cu``, is one template over the monoid (add, max, min), the
value type and a segmented flag, and a call is one single-pass launch with
decoupled look-back over windows of tiles, in an order of combination that
does not depend on timing; its source note gives its design and bound.

* ``scan_apply(x, mono, out=None)``: y = inclusive scan of x.  ``out``
  may be x itself (in place).
* ``segscan_apply(heads, x, mono, out=None)``: the scan restarts at every
  nonzero head flag (u8 or bool).
* ``scan_tiled(x, mono, heads, tile, window, shift)``: the kernel's tile
  and window decomposition in plain PyTorch, at any tile and window size,
  for the tests (nothing on the main path calls it).

The value types are f32, f64, i32, i64 and bf16 (carried in f32 and
stored as bf16, as the Pallas kernels do).  MAX and MIN propagate NaN as
``jnp.maximum`` does; integer sums wrap in their own type.  Any contiguous
x, out and heads work, views at any offset included (the kernel reads an
unaligned start itself).  On a CPU tensor the plain version runs; on a
CUDA tensor the kernel launches, and any other type raises.  The count
``launches`` on each wrapper counts its kernel's launches (one per call),
not the plain version's.

The kernel's scratch (a status word and an 8-byte value per tile, and two
counters; the words and counters left zeroed by every launch) is kept per
(device, stream) by ``cuda_scratch.StreamScratch``.  A call allocates its
output, nothing else, and launches once.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import written
from .cuda_scratch import StreamScratch

__all__ = ["scan_apply", "segscan_apply", "scan_plain", "segscan_plain",
           "scan_tiled", "associative_scan"]

#: kernel monoid codes (csrc/scan.cu ``Mono``)
_MONOIDS = {"add": 0, "max": 1, "min": 2}
#: kernel value-type codes (csrc/scan.cu ``by_type``)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3, torch.bfloat16: 4}
_OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}

#: tiles the scratch holds at least (2^24 f64 elements)
_MIN_TILES = 4096


def _carry_dtype(dt: torch.dtype) -> torch.dtype:
    """The type a scan of ``dt`` carries its running value in."""
    return torch.float32 if dt == torch.bfloat16 else dt


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_scan")
    if not getattr(lib, "_vex_bound", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.vex_scan.argtypes = [i32, i32, ptr, ptr, i64, ptr, ptr, ptr, ptr]
        lib.vex_segscan.argtypes = [i32, i32, ptr, ptr, ptr, i64, ptr, ptr,
                                    ptr, ptr]
        lib.vex_scan.restype = lib.vex_segscan.restype = i32
        lib.vex_scan_tile.argtypes = [i32]
        lib.vex_scan_tile.restype = lib.vex_scan_window.restype = i32
        lib.vex_cuda_error_string.argtypes = [i32]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        #: elements per tile by dtype code, and tiles per look-back window
        lib.tiles = {c: lib.vex_scan_tile(c) for c in _DTYPE_CODE.values()}
        lib.window = lib.vex_scan_window()
        lib._vex_bound = True
    return lib


#: per (device, stream): a status word and an 8-byte value slot a tile,
#: and the counters
_scratch = StreamScratch(2, _MIN_TILES)


def associative_scan(fn, elems):
    """Inclusive scan of ``elems`` (a tensor, or a tuple of tensors of one
    length) under the associative ``fn``, in log2(n) doubling steps
    (Hillis-Steele): the counterpart of ``jax.lax.associative_scan`` for
    custom operators, in plain PyTorch on any device.  ``fn(a, b)`` takes
    the earlier operand first; for tuples, ``a`` and ``b`` are tuples."""
    tup = isinstance(elems, tuple)
    xs = elems if tup else (elems,)
    n = xs[0].shape[0]
    d = 1
    while d < n:
        a = tuple(x[:-d] for x in xs)
        b = tuple(x[d:] for x in xs)
        r = fn(a, b) if tup else (fn(a[0], b[0]),)
        xs = tuple(torch.cat([x[:d], torch.as_tensor(y).to(x.device)])
                   for x, y in zip(xs, r))
        d *= 2
    return xs if tup else xs[0]


def _check_mono(mono: str) -> None:
    if mono not in _MONOIDS:
        raise ValueError(f"scan monoid {mono!r}: one of {sorted(_MONOIDS)}")


def scan_plain(x: torch.Tensor, mono: str) -> torch.Tensor:
    """torch.cumsum / cummax / cummin in the carry type, cast back."""
    _check_mono(mono)
    xc = x.to(_carry_dtype(x.dtype))
    if x.numel() == 0:
        return x.clone()
    if mono == "add":
        # integer sums wrap in their own type: sum wide, then cast
        wide = torch.int64 if not xc.is_floating_point() else xc.dtype
        y = torch.cumsum(xc, 0, dtype=wide)
    elif mono == "max":
        y = torch.cummax(xc, 0).values
    else:
        y = torch.cummin(xc, 0).values
    return y.to(x.dtype)


def segscan_plain(heads: torch.Tensor, x: torch.Tensor,
                  mono: str) -> torch.Tensor:
    """The pair scan (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2))
    by ``associative_scan``, in the carry type, cast back."""
    _check_mono(mono)
    op = _OPS[mono]
    xc = x.to(_carry_dtype(x.dtype))
    f = heads.to(device=x.device, dtype=torch.bool)

    def combine(a, b):
        (fa, va), (fb, vb) = a, b
        return fa | fb, torch.where(fb, vb, op(va, vb))

    return associative_scan(combine, (f, xc))[1].to(x.dtype)


def _identity(mono: str, dt: torch.dtype) -> torch.Tensor:
    """The kernel's identity of ``mono`` in the carry type ``dt``."""
    if mono == "add":
        return torch.zeros((), dtype=dt)
    if dt.is_floating_point:
        lo, hi = -float("inf"), float("inf")
    else:
        lo, hi = torch.iinfo(dt).min, torch.iinfo(dt).max
    return torch.tensor(lo if mono == "max" else hi, dtype=dt)


def scan_tiled(x: torch.Tensor, mono: str = "add",
               heads: Optional[torch.Tensor] = None, tile: int = 4096,
               window: int = 256, shift: int = 0) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch, one element at a time,
    on a CPU tensor: ``shift`` identity elements (head flag 0) stand before
    x, as the kernel's alignment shift puts them; tiles of ``tile``
    elements each scan themselves from their exclusive prefix, and tile t
    in window [b, b + window) takes as that prefix P(b - 1) . F, F the
    fold, in order, of AGG(b) ... AGG(t - 1) (P(b - 1) alone when t = b;
    the identity when b = 0), where AGG is a tile's aggregate and P(t) =
    prefix(t) . AGG(t) for the tile that ends a window; segmented, the
    prefix is F when F holds a head, as the kernel then does not wait for
    P(b - 1).  ``heads`` (u8 or bool) makes it the segmented scan.  The
    within-tile bracketing is sequential, not the kernel's, so float sums
    agree with the kernel up to rounding and every other result bitwise.
    For the tests only: nothing on the main path calls it."""
    _check_mono(mono)
    if x.numel() == 0:
        return x.clone()
    op = _OPS[mono]
    xc = x.to(_carry_dtype(x.dtype))
    ident = (False, _identity(mono, xc.dtype))
    flags = ([False] * x.shape[0] if heads is None
             else heads.to(torch.bool).tolist())
    elems = [ident] * shift + list(zip(flags, xc.unbind()))
    elems += [ident] * (-len(elems) % tile)

    def comb(a, b):             # a is the earlier pair
        return a[0] or b[0], b[1] if b[0] else op(a[1], b[1])

    def fold(pairs):
        acc = pairs[0]
        for p in pairs[1:]:
            acc = comb(acc, p)
        return acc

    tiles = [elems[i:i + tile] for i in range(0, len(elems), tile)]
    agg = [fold(t) for t in tiles]
    ends = {}                   # P(t) of the tiles that end a window
    out = []
    for t, els in enumerate(tiles):
        b = t - t % window
        prefix = ends[b - 1] if b > 0 else ident
        if t > b:
            f = fold(agg[b:t])
            prefix = f if f[0] else comb(prefix, f)
        if t % window == window - 1:
            ends[t] = comb(prefix, agg[t])
        run = prefix
        for e in els:
            run = comb(run, e)
            out.append(run[1])
    n = x.shape[0]
    return torch.stack(out[shift:shift + n]).to(x.dtype)


def _prepare(x: torch.Tensor, out: Optional[torch.Tensor], what: str):
    if x.ndim != 1:
        raise ValueError(f"{what} of a tensor of shape {tuple(x.shape)}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise NotImplementedError(f"{what} kernel has no form for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} operand must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous tensor like x")
    return code, out


def _launch(entry: str, what: str, x: torch.Tensor, code: int,
            *args) -> None:
    """The library's ``entry``(code, *args, n, status, values, counters,
    stream) on x's device and current stream, with that stream's scratch;
    raises if the launch was refused."""
    device = x.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _lib()
    n = x.shape[0]
    # the raw stream handle (~0.1 us; a Stream object costs ~3 us)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    words, counters = _scratch.get(device, stream,
                                   -(-(n + 15) // lib.tiles[code]))
    call = (code, *args, n, words[0].data_ptr(), words[1].data_ptr(),
            counters.data_ptr(), stream)
    if torch.cuda.current_device() == device.index:
        rc = getattr(lib, entry)(*call)
    else:
        with torch.cuda.device(device):
            rc = getattr(lib, entry)(*call)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())


def scan_apply(x: torch.Tensor, mono: str = "add",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = inclusive scan of the 1-D ``x`` under ``mono`` ("add", "max" or
    "min"), written to ``out`` when given (``out`` may be ``x``)."""
    _check_mono(mono)
    if x.device.type == "cpu":
        y = scan_plain(x, mono)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no scan kernel for {x.device}")
    code, out = _prepare(x, out, "scan")
    if x.shape[0] == 0:
        return out
    _launch("vex_scan", "scan", x, code, _MONOIDS[mono],
            x.data_ptr(), out.data_ptr())
    written(out)
    scan_apply.launches += 1
    return out


def segscan_apply(heads: torch.Tensor, x: torch.Tensor, mono: str = "add",
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = segmented inclusive scan of the 1-D ``x``: a segment starts at
    every nonzero ``heads`` entry (u8 or bool, one per element)."""
    _check_mono(mono)
    if heads.shape != x.shape:
        raise ValueError(f"segmented scan: {tuple(heads.shape)} head flags "
                         f"for {tuple(x.shape)} values")
    if x.device.type == "cpu":
        y = segscan_plain(heads, x, mono)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no segmented scan kernel for {x.device}")
    code, out = _prepare(x, out, "segmented scan")
    if heads.dtype == torch.bool:
        heads = heads.view(torch.uint8)
    if (heads.dtype != torch.uint8 or heads.device != x.device
            or not heads.is_contiguous()):
        raise ValueError("segmented scan: head flags must be a contiguous "
                         "u8 or bool tensor on x's device")
    if x.shape[0] == 0:
        return out
    _launch("vex_segscan", "segmented scan", x, code,
            _MONOIDS[mono], heads.data_ptr(), x.data_ptr(), out.data_ptr())
    written(out)
    segscan_apply.launches += 1
    return out


#: launches of the CUDA kernels (not of the plain versions)
scan_apply.launches = 0
segscan_apply.launches = 0
