"""Assignment through a permutation: the CUDA kernels' wrappers, their
plain PyTorch versions, the CPU mirror of the range plan and the route.

Replaces, for the forms ``route`` sends here, V3's generated Triton
kernel (``expr/triton_emit.py`` ``assign_to_view``: one ``tl.store`` or
``tl.atomic_*`` a lane at its index), which stands where the JAX package
has XLA's scatter (``vexcl_tpu/expr/view.py:60-100``,
``vexcl_tpu/ops/atomic.py:57-124``).  The kernels, ``csrc/scatter.cu``
(its source note gives the design and bound):

* ``scatter_ranges(out, idx, val, mode, scalar=None)``, form A: the
  target cut into ranges of ``RANGE_BYTES`` (one block's shared memory),
  the updates counted per (tile, range), scanned, distributed into
  (offset, value) pairs range by range, and each range that received any
  built in shared memory and written back whole: four kernels, one call;
* ``scatter_privatized(out, idx, val, mode, scalar=None)``, form B: each
  block combines its share of the updates in a window of the target in
  shared memory and merges it into the target with one coalesced global
  atomic an element it changed (the histogram among them).

Operands: ``out`` the contiguous 1-D target (f32, f64, i32 or i64),
updated in place; ``idx`` n indices (i32 or i64; truncated to i32, a
negative one wrapped once by +N, the rest out of range dropped, as the
reference does); ``val`` n values of ``out``'s type, or None with
``scalar`` (a 0-d CPU tensor of ``out``'s type).  ``mode``: ``store``
(duplicates unspecified, as the reference has them), ``add``, ``min``,
``max`` (float min and max as ``scatter_reduce_``'s amin and amax on the
card: NaN propagates, and of +0.0 and -0.0 the new one lands).  On a CPU
tensor each wrapper runs the plain version (``scatter_plain``); on a
CUDA tensor its kernels launch or the call raises.  ``launches`` on each
wrapper counts its calls that launched (form A: four kernels a call).

``route(mode, dtype, target_len, updates)`` is the pure
choice between the two forms and V3's Triton kernel ("ranges",
"privatized" or None), from thresholds a sweep on the card set
(``scripts/torch_scatter_turns.py``; PERF.md §6).  ``ranges_mirror`` is
form A's plan in tensor code (counts, range-major offsets, the stable
distribution, the build) for the CPU tests.  Scratch (the count matrix,
the pairs) is allocated by the wrapper with ``torch.empty`` a call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._build import written

__all__ = ["ROUTE_MODES", "route", "range_plan", "window_plan", "RangePlan",
           "scatter_ranges", "scatter_privatized", "scatter_plain",
           "ranges_mirror"]

#: the modes the kernels take (``triton_emit.TARGET_MODES`` less ``mul``)
ROUTE_MODES = ("store", "add", "min", "max")

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3}
_MODE_CODE = {"store": 0, "add": 1, "min": 2, "max": 3}
_SIZE = {torch.float32: 4, torch.float64: 8, torch.int32: 4, torch.int64: 8}
#: the numpy type of each target type, and of its bits
NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64,
            torch.int32: np.int32, torch.int64: np.int64}
_NP_BITS = {4: np.uint32, 8: np.uint64}

#: target bytes a range of form A holds (its build block's shared memory)
RANGE_BYTES = 1 << 17
#: target bytes of a window of form B
WINDOW_BYTES = 1 << 17
#: updates a round of the distribute kernel (csrc/scatter.cu ``kChunk``);
#: a tile is a multiple of it
CHUNK = 4096
#: most ranges (the distribute kernel's shared memory: 46 bytes a range)
MAX_RANGES = 2048
#: tiles form A cuts the updates into where there are enough (several
#: blocks an SM), and the most words of the (tile, range) count matrix,
#: which stays in L2
TILES = 512
MATRIX_WORDS = 1 << 22
#: the most bytes of a tile's pairs the distribute kernel stages in shared
#: memory (a tile is at most this many pairs of offset and value)
STAGE_BYTES = 192 * 1024
#: shared memory an SM offers its blocks (H100: 228 KB, 1 KB of it
#: reserved a block)
_SM_SHARED = 233472

# The route's thresholds: where each form beat V3's Triton kernel in
# events ms of back-to-back API calls (=, atomic_add, atomic_min and
# atomic_max into f32, f64, i32 and i64 targets and the histogram, targets
# of 2^14 to 2^28 bytes, 1/256 to 256 updates an element;
# scripts/torch_scatter_turns.py --sweep on an H100 80GB HBM3 at 700 W,
# PERF.md §6).  Below them the single-pass kernel wins: its target stays
# in the 50 MB L2 and the host's launch, not the device, sets the time.
#: form A: the least target elements, updates a target element, and updates
RANGES_MIN_TARGET = 1 << 23
RANGES_MIN_PER_ELEMENT = 1 / 4
RANGES_MIN_UPDATES = 1 << 22
#: form B: the most windows, and the least updates (64 or more an
#: element of four windows); float min and max (a compare-and-swap loop
#: in shared memory) only in one window, beyond which they lost
PRIVATIZED_MAX_WINDOWS = 4
PRIVATIZED_FLOAT_MIN_MAX_WINDOWS = 1
PRIVATIZED_MIN_UPDATES = 1 << 23


class RangePlan(NamedTuple):
    """Form A's cut: ranges of 2^log_r elements, tiles of ``tile``
    updates."""

    log_r: int
    ranges: int
    tile: int
    tiles: int


def range_plan(target_len: int, updates: int, itemsize: int,
               range_bytes: int = None) -> RangePlan:
    """Ranges of ``range_bytes`` (``RANGE_BYTES``) of the target; tiles of
    the fewest rounds of ``CHUNK`` updates that make at most ``TILES``
    tiles and keep the count matrix within ``MATRIX_WORDS``, and at most
    the pairs of ``STAGE_BYTES`` (``route`` takes form A only where the
    matrix fits)."""
    log_r = ((range_bytes or RANGE_BYTES) // itemsize).bit_length() - 1
    ranges = max(1, -(-target_len >> log_r))
    rounds = max(1, -(-updates // (CHUNK * TILES)),
                 -(-updates * ranges // (MATRIX_WORDS * CHUNK)))
    rounds = min(rounds, max(1, STAGE_BYTES // (itemsize + 2) // CHUNK))
    tile = CHUNK * rounds
    return RangePlan(log_r, ranges, tile, max(1, -(-updates // tile)))


def window_plan(target_len: int, itemsize: int) -> Tuple[int, int]:
    """(elements a window, windows) of form B: ``WINDOW_BYTES`` of the
    target's type."""
    window = WINDOW_BYTES // itemsize
    return window, -(-target_len // window)


def _scalar_np(scalar, dtype: torch.dtype):
    """A scalar (a number, numpy scalar or 0-d tensor) as a numpy scalar
    of ``dtype``'s type, cast as ``Tensor.to`` casts."""
    if isinstance(scalar, torch.Tensor):
        return scalar.to(dtype).cpu().numpy()[()]
    return np.asarray(scalar).astype(NP_TYPES[dtype])[()]


def route(mode: str, dtype: torch.dtype, target_len: int,
          updates: int) -> Optional[str]:
    """"ranges" (form A), "privatized" (form B) or None (V3's Triton
    kernel) for ``updates`` updates by ``mode`` into a ``dtype`` target of
    ``target_len`` elements."""
    if mode not in ROUTE_MODES or dtype not in _DTYPE_CODE \
            or updates <= 0 or target_len <= 0 \
            or max(updates, target_len) >= 1 << 31:
        return None
    size = _SIZE[dtype]
    if mode != "store":
        _, windows = window_plan(target_len, size)
        most = PRIVATIZED_FLOAT_MIN_MAX_WINDOWS if mode != "add" \
            and dtype.is_floating_point else PRIVATIZED_MAX_WINDOWS
        if windows <= most and updates >= PRIVATIZED_MIN_UPDATES:
            return "privatized"
    plan = range_plan(target_len, updates, size)
    if plan.ranges <= MAX_RANGES \
            and plan.ranges * plan.tiles <= MATRIX_WORDS \
            and target_len >= RANGES_MIN_TARGET \
            and updates >= RANGES_MIN_UPDATES \
            and updates >= RANGES_MIN_PER_ELEMENT * target_len:
        return "ranges"
    return None


def _targets(idx: torch.Tensor, target_len: int):
    """(index as i64, valid) by the reference's rule."""
    j = idx.to(torch.int32).to(torch.int64)
    j = torch.where(j < 0, j + target_len, j)
    return j, (j >= 0) & (j < target_len)


def _values(val, scalar, n: int, out: torch.Tensor) -> torch.Tensor:
    if val is not None:
        return val
    return torch.as_tensor(scalar, dtype=out.dtype).to(out.device).expand(n)


def scatter_plain(out: torch.Tensor, idx: torch.Tensor,
                  val: Optional[torch.Tensor], mode: str,
                  scalar=None) -> None:
    """``index_put_``, ``index_add_`` or ``scatter_reduce_`` (amin, amax)
    at the valid indices."""
    j, valid = _targets(idx, out.numel())
    v = _values(val, scalar, idx.numel(), out)
    j, v = j[valid], v[valid]
    if mode == "store":
        out.index_put_((j,), v.clone())
    elif mode == "add":
        out.index_add_(0, j, v)
    else:
        out.scatter_reduce_(0, j, v, "a" + mode)


def _min_max(old: torch.Tensor, v: torch.Tensor, mode: str) -> torch.Tensor:
    """The kernels' float min/max (PyTorch's on the card): a NaN in old
    stays, else v unless old wins strictly."""
    keep = (v < old) if mode == "max" else (old < v)
    if old.dtype.is_floating_point:
        keep = keep | torch.isnan(old)
    return torch.where(keep, old, v)


def _group_rank(key: torch.Tensor) -> torch.Tensor:
    """Each element's rank among the earlier elements of equal key."""
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    start = torch.cummax(torch.where(first, torch.arange(ks.numel()),
                                     torch.zeros_like(ks)), 0).values
    rank = torch.empty_like(ks)
    rank[order] = torch.arange(ks.numel()) - start
    return rank


def _apply_in_order(out: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                    mode: str) -> None:
    """Apply the updates (g, v) to ``out`` in their order: each round the
    next update of every index."""
    if g.numel() == 0:
        return
    rank = _group_rank(g)
    for q in range(int(rank.max()) + 1):
        sel = rank == q
        gq, vq = g[sel], v[sel]
        if mode == "store":
            out[gq] = vq
        elif mode == "add":
            out[gq] = out[gq] + vq
        else:
            out[gq] = _min_max(out[gq], vq, mode)


def ranges_mirror(out: torch.Tensor, idx: torch.Tensor,
                  val: Optional[torch.Tensor], mode: str, scalar=None,
                  plan: RangePlan = None) -> Dict[str, torch.Tensor]:
    """Form A on CPU tensors, step by step as its kernels take it, at any
    plan: (a) the (tile, range) counts, (b) their exclusive scan in
    range-major order, (c) each valid update's pair at its (tile, range)
    run's offset plus its rank among the run's updates, (d) each range's
    pairs applied in order.  The kernel places a run's pairs in the order
    of its shared-memory atomics, the mirror in the index's (stable); (d)
    applies a range's pairs at once, so no mode's result depends on it.
    Updates ``out`` in place and returns the intermediates (counts,
    offsets, totals, bases, ppos, pval)."""
    n, target_len = idx.numel(), out.numel()
    if plan is None:
        plan = range_plan(target_len, n, out.element_size())
    log_r, ranges, tile, tiles = plan
    j, valid = _targets(idx, target_len)
    tile_of = torch.arange(n) // tile
    r = j >> log_r
    # (a)
    cell = (tile_of * ranges + r)[valid]
    counts = torch.bincount(cell, minlength=tiles * ranges).view(tiles,
                                                                 ranges)
    # (b): range-major exclusive scan; a range's first pair
    flat = counts.t().reshape(-1)
    offsets = (torch.cumsum(flat, 0) - flat).view(ranges, tiles)
    totals = counts.sum(0)
    bases = torch.cumsum(totals, 0) - totals
    # (c): rank within (tile, range) in index order
    key = (r * tiles + tile_of)[valid]
    rank = _group_rank(key)
    pos = offsets.reshape(-1)[key] + rank
    m = int(valid.sum())
    ppos = torch.empty(m, dtype=torch.int64)
    ppos[pos] = (j & ((1 << log_r) - 1))[valid]
    pval = None
    if val is not None:
        pval = torch.empty(m, dtype=out.dtype)
        pval[pos] = val[valid]
    # (d): each range's pairs, in order
    owner = torch.repeat_interleave(torch.arange(ranges), totals)
    g = (owner << log_r) + ppos
    v = pval if pval is not None else _values(None, scalar, m, out)
    _apply_in_order(out, g, v, mode)
    return {"counts": counts, "offsets": offsets, "totals": totals,
            "bases": bases, "ppos": ppos, "pval": pval}


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_scatter")
    if not getattr(lib, "_vex_bound", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        u64 = ctypes.c_ulonglong
        lib.vex_scatter_ranges.argtypes = [
            ptr, i32, i32, ptr, i32, i64, ptr, u64, i32, i32, i32, i64, i64,
            ptr, ptr, ptr, ptr, ptr, ptr]
        lib.vex_scatter_privatized.argtypes = [
            ptr, i32, i32, ptr, i32, i64, ptr, u64, i32, i32, i32, i32, ptr]
        for f in (lib.vex_scatter_ranges, lib.vex_scatter_privatized,
                  lib.vex_scatter_chunk):
            f.restype = i32
        lib.vex_cuda_error_string.argtypes = [i32]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        if lib.vex_scatter_chunk() != CHUNK:
            raise RuntimeError("csrc/scatter.cu's chunk differs from "
                               "cuda_scatter.CHUNK")
        lib._vex_bound = True
    return lib


_sm_count: Dict[int, int] = {}


def _check(out: torch.Tensor, idx: torch.Tensor, val, mode: str,
           modes=ROUTE_MODES) -> None:
    if out.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"no scatter kernel for {out.dtype}")
    if mode not in modes:
        raise NotImplementedError(f"no scatter kernel for mode {mode!r}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise NotImplementedError(f"scatter indices are i32 or i64, not "
                                  f"{idx.dtype}")
    if out.ndim != 1 or idx.ndim != 1 or not out.is_contiguous() \
            or not idx.is_contiguous():
        raise ValueError("scatter: a contiguous 1-D target and index")
    if val is not None and (val.dtype != out.dtype or val.shape != idx.shape
                            or not val.is_contiguous()):
        raise ValueError("scatter: values of the target's type, one an "
                         "index, contiguous")
    if any(t.device != out.device for t in (idx, val) if t is not None):
        raise ValueError("scatter operands on one device")
    if max(out.numel(), idx.numel()) >= 1 << 31:
        raise NotImplementedError("scatter kernels take fewer than 2^31 "
                                  "elements")


def _scalar_bits(scalar, dtype: torch.dtype) -> int:
    if scalar is None:
        return 0
    return int(_scalar_np(scalar, dtype).view(_NP_BITS[_SIZE[dtype]]))


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())


def _on(dev: torch.device, fn, args) -> int:
    """fn(*args) with ``dev`` the current device."""
    if torch.cuda.current_device() == dev.index:
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _ranges_launch(out: torch.Tensor, idx: torch.Tensor,
                   val: Optional[torch.Tensor], mode: str, scalar=None,
                   plan: RangePlan = None, keep: bool = False):
    """Form A's four launches on CUDA tensors; with ``keep``, returns its
    scratch (counts, totals, bases, ppos, pval)."""
    n, target_len = idx.numel(), out.numel()
    if plan is None:
        plan = range_plan(target_len, n, out.element_size())
    if plan.ranges > MAX_RANGES or plan.tile % CHUNK:
        raise NotImplementedError(f"form A takes at most {MAX_RANGES} "
                                  f"ranges and tiles of whole rounds")
    dev = out.device
    lib = _lib()
    # two allocations: the u32 words, and the pairs (values 16-byte aligned)
    cells = plan.tiles * plan.ranges
    words = torch.empty(cells + 2 * plan.ranges, dtype=torch.int32,
                        device=dev)
    m = max(n, 1)
    at = -(-2 * m // 16) * 16
    size = out.element_size() if val is not None else 0
    pairs = torch.empty(at + m * size, dtype=torch.uint8, device=dev)
    w, p = words.data_ptr(), pairs.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    args = (out.data_ptr(), _DTYPE_CODE[out.dtype], target_len,
            idx.data_ptr(), int(idx.dtype == torch.int64), n,
            val.data_ptr() if val is not None else None,
            _scalar_bits(scalar, out.dtype), _MODE_CODE[mode], plan.log_r,
            plan.ranges, plan.tile, plan.tiles, w, w + 4 * cells,
            w + 4 * (cells + plan.ranges), p,
            p + at if val is not None else None, stream)
    _raise(lib, _on(dev, lib.vex_scatter_ranges, args), "scatter_ranges")
    written(out)
    if not keep:
        return None
    return {"counts": words[:cells],
            "totals": words[cells:cells + plan.ranges],
            "bases": words[cells + plan.ranges:],
            "ppos": pairs[:2 * m].view(torch.int16),
            "pval": pairs[at:].view(out.dtype) if val is not None else None}


def scatter_ranges(out: torch.Tensor, idx: torch.Tensor,
                   val: Optional[torch.Tensor], mode: str,
                   scalar=None) -> None:
    """Form A: ``out`` updated in place at ``idx`` by ``mode`` with
    ``val`` (or ``scalar``); see the module docstring."""
    _check(out, idx, val, mode)
    if out.device.type == "cpu":
        scatter_plain(out, idx, val, mode, scalar)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no scatter kernel for {out.device}")
    if idx.numel() == 0:
        return
    _ranges_launch(out, idx, val, mode, scalar)
    scatter_ranges.launches += 1


#: calls that launched form A's kernels (not of the plain version)
scatter_ranges.launches = 0


def scatter_privatized(out: torch.Tensor, idx: torch.Tensor,
                       val: Optional[torch.Tensor], mode: str,
                       scalar=None) -> None:
    """Form B: ``out`` updated in place at ``idx`` by ``mode`` (add, min,
    max) with ``val`` (or ``scalar``); see the module docstring."""
    _check(out, idx, val, mode, ("add", "min", "max"))
    if out.device.type == "cpu":
        scatter_plain(out, idx, val, mode, scalar)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no scatter kernel for {out.device}")
    n, target_len = idx.numel(), out.numel()
    if n == 0:
        return
    dev = out.device
    size = out.element_size()
    window, windows = window_plan(target_len, size)
    smem = window * size
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _sm_count[dev.index] = sms
    per_sm = max(1, min(2, _SM_SHARED // (smem + 1024)))
    blocks = max(1, min(-(-n // 4096), sms * per_sm // windows))
    lib = _lib()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _on(dev, lib.vex_scatter_privatized, (
        out.data_ptr(), _DTYPE_CODE[out.dtype], target_len, idx.data_ptr(),
        int(idx.dtype == torch.int64), n,
        val.data_ptr() if val is not None else None,
        _scalar_bits(scalar, out.dtype), _MODE_CODE[mode], window, windows,
        blocks, stream))
    _raise(lib, rc, "scatter_privatized")
    written(out)
    scatter_privatized.launches += 1


#: calls that launched form B's kernel (not of the plain version)
scatter_privatized.launches = 0


#: the launch function of each form ``route`` names
FORMS = {"ranges": scatter_ranges, "privatized": scatter_privatized}
