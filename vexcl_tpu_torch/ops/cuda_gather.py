"""The gather through a permutation: the CUDA kernels' wrapper, their
plain PyTorch version, the CPU mirror of the range plan and the route.

Replaces, for the sizes ``route`` sends here, the indexed loads of V1's
generated Triton kernel (``expr/triton_emit.py``, ``PermutationView.
emit_index``: one load a lane at its index), which stands where the JAX
package has XLA's gather (``vexcl_tpu/expr/view.py:283-286``,
``jnp.take(x, idx.astype(int32))``).  The kernels, ``csrc/gather.cu``
(its source note gives the design and bound), are one call of
``gather_ranges(out, idx, src)``: the destinations cut into tiles, each
tile's entries counting-sorted by source range (partition), each range
of the source read once into one block's shared memory and its entries
served from there (gather), and each tile's values put back in
destination order (restore); three kernels.

Operands: ``out`` n elements (f32, f64, i32 or i64, contiguous, 1-D);
``idx`` n indices (i32 or i64; truncated to i32, a negative one wrapped
once by +N, one still out of range reading the fill: NaN or the least
signed integer, as ``jnp.take``); ``src`` N elements of ``out``'s type.
On a CPU tensor the wrapper runs the plain version (``gather_plain``); on
a CUDA tensor the kernels launch or the call raises.
``gather_ranges.launches`` counts its calls that launched.

``route(dtype, src_len, n, index_dtype)`` is the pure choice between the
form and V1's single pass, from thresholds a sweep on the card set
(``scripts/torch_gather_turns.py --sweep``; PERF.md §6).  The form also
serves gathers at the flat index of two coordinate arrays (a nearest
2-D image sample, ``slicer[i, j]``) through its fused variant,
``gather_coords``, whose partition computes the index;
``index_route(dtype, src_len, n)`` chooses for them, from
``scripts/torch_image_turns.py --sweep``.  ``takes`` is what the kernels
take.
``ranges_mirror`` is the form's plan in tensor code (the tiles' bucket
starts, the sorted indices and offsets, the values, the restore) for the
CPU tests.  Scratch is allocated by the wrapper with ``torch.empty`` a
call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from .._build import written
from .cuda_scatter import _SIZE, _on, _raise

__all__ = ["route", "index_route", "takes", "gather_plan", "Coords",
           "coords_index", "gather_coords", "COORD_TYPES", "GatherPlan",
           "gather_ranges", "gather_plain", "ranges_mirror", "fill_bits"]

_BITS = {4: torch.int32, 8: torch.int64}

# The cut, from scripts/torch_gather_turns.py --variants at 2^24 f32 and
# f64 (device µs summed over the three kernels on an H100 80GB HBM3 at
# 700 W, PERF.md §6): ranges of 2^14 elements (64 KB of f32, 128 KB of
# f64) and tiles of 128 KB of values were the fastest of 16-128 KB ranges
# and 2^13-2^15 destinations a tile.
#: source elements a range (one gather block's shared memory; at most
#: 2^16, as an index within a range is u16)
RANGE_ELEMENTS = 1 << 14
#: values a tile holds, in bytes (the restore's shared memory; the tile's
#: offsets are u16, so at most 2^15 destinations)
TILE_BYTES = 1 << 17
#: the most ranges the partition counts (csrc/gather.cu ``kMaxRanges``),
#: and the shared memory a block may take (H100: 227 KB)
MAX_RANGES = 8192
SMEM_BYTES = 227 * 1024
#: the gather block's shared memory beside its range: a round's tiles'
#: first places and run starts (csrc/gather.cu ``gather_smem``)
_WALK_BYTES = (2 * 1024 + 1) * 4

# The route's thresholds: where the form beat V1's single pass in events
# ms of back-to-back API calls through random indices
# (scripts/torch_gather_turns.py --sweep: f32, f64, i32 and i64 sources of
# 2^14 to 2^28 bytes, 1/16 to 16 destinations an element, i32 and i64
# indices, on an H100 80GB HBM3 at 700 W; PERF.md §6): from sources of 64
# MB, with a quarter of a destination an element of 4 bytes (1.22-1.56x
# V1's time; one point 0.96) and one an element of 8 bytes (1.12-1.47x;
# at a quarter 0.70-1.03x).  Below 64 MB V1 wins: the 50 MB L2 serves its
# random loads.  Sorted indices lose where the route sends them
# (0.23-0.74x: V1 then streams the source); the route sees sizes and
# types only.
#: the least source bytes, and destinations a source element by width
MIN_SOURCE_BYTES = 1 << 26
MIN_PER_ELEMENT = {4: 1 / 4, 8: 1}
# The index route's thresholds (the fused variant, its partition
# computing the index, against V1's single pass that computes the index
# and loads it), from scripts/torch_image_turns.py --sweep (nearest
# samples and [i, j] of f32, f64 and i32 tables of 2^14 to 2^28 bytes,
# 1/16 to 16 points an element, uniform and clustered, each form forced,
# events ms a call on an H100 80GB HBM3 at 700 W; PERF.md §6).  With
# uniform points the fused variant took 0.59-0.72x V1's time from a point
# an element of 4-byte tables of 64 MB and a quarter from 128 MB, and
# 0.78-0.94x from a point an element of 8-byte tables of 64 MB.  Below,
# V1 wins 1.1-3x: L2 serves its loads, and the form's launches cost host
# time.  Clustered points lose 1.5-3.7x; the route sees sizes and types
# only.
#: element width -> ((least table bytes, least points a table element),
#: ...): the route takes a gather meeting any pair
INDEX_ROUTE = {
    4: ((1 << 26, 1), (1 << 27, 1 / 4)),
    8: ((1 << 26, 1),),
}


class GatherPlan(NamedTuple):
    """The form's cut: source ranges of 2^log_s elements, tiles of
    ``tile`` destinations."""

    log_s: int
    ranges: int
    tile: int
    tiles: int


def gather_plan(src_len: int, n: int, itemsize: int,
                range_bytes: int = None, tile: int = None) -> GatherPlan:
    """Ranges of ``range_bytes`` of the source (``RANGE_ELEMENTS``
    elements; at most 2^16), tiles of ``tile`` destinations
    (``TILE_BYTES`` of values, at most 2^15)."""
    per = range_bytes // itemsize if range_bytes else RANGE_ELEMENTS
    log_s = min(16, max(4, per.bit_length() - 1))
    tile = tile or min(1 << 15, TILE_BYTES // itemsize)
    return GatherPlan(log_s, max(1, -(-src_len >> log_s)), tile,
                      max(1, -(-n // tile)))


def _fits(plan: GatherPlan, itemsize: int) -> bool:
    """Whether the kernels take the plan: the ranges the partition counts,
    and each kernel's shared memory."""
    return (plan.ranges <= MAX_RANGES and plan.tile % 8 == 0
            and plan.tile <= 1 << 15
            and max((itemsize << plan.log_s) + _WALK_BYTES,
                    itemsize * plan.tile,
                    6 * plan.tile + 4 * (plan.ranges + 1)) <= SMEM_BYTES)


def takes(dtype: torch.dtype, src_len: int, n: int) -> bool:
    """Whether the kernels take ``n`` destinations of a ``dtype`` source
    of ``src_len`` elements (types, sizes and the plan's memory)."""
    if dtype not in _SIZE or n <= 0 or src_len <= 0 \
            or max(n, src_len) >= 1 << 31:
        return False
    return _fits(gather_plan(src_len, n, _SIZE[dtype]), _SIZE[dtype])


def route(dtype: torch.dtype, src_len: int, n: int,
          index_dtype: torch.dtype) -> bool:
    """True where the form takes ``n`` destinations gathered through an
    ``index_dtype`` index from a ``dtype`` source of ``src_len``
    elements, False where V1's single pass keeps them."""
    if index_dtype not in (torch.int32, torch.int64) \
            or not takes(dtype, src_len, n):
        return False
    size = _SIZE[dtype]
    return (src_len * size >= MIN_SOURCE_BYTES
            and n >= MIN_PER_ELEMENT[size] * src_len)


def index_route(dtype: torch.dtype, src_len: int, n: int) -> bool:
    """True where a gather at the flat index of two coordinate arrays (a
    nearest 2-D image sample, ``slicer[i, j]``) of ``n`` destinations
    from a ``dtype`` table of ``src_len`` elements takes the fused
    variant (``gather_coords``); False where V1's single pass keeps
    it."""
    if not takes(dtype, src_len, n):
        return False
    size = _SIZE[dtype]
    return any(src_len * size >= least and n >= per * src_len
               for least, per in INDEX_ROUTE[size])


#: the coordinate types of the fused variant (``gather_coords``), by the
#: code ``vex_gather_coords`` takes
COORD_TYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3}


class Coords(NamedTuple):
    """Two coordinate arrays and the flat index they give, the fused
    variant's operand: j = base + c0 * strides[0] + c1 * strides[1], each
    c clamped into [0, dims[k]): a float rounded half to even and
    converted to i32 saturating (NaN 0: a nearest image sample), an
    integer wrapped once by +dims[k] (a slicer's index-array key)."""

    a: torch.Tensor
    b: torch.Tensor
    dims: Tuple[int, int]
    strides: Tuple[int, int]
    base: int


def coords_index(c: Coords) -> torch.Tensor:
    """The flat index (i64) of ``c`` in tensor code: the fused variant's
    plain version of the index."""
    j = torch.full(c.a.shape, c.base, dtype=torch.int64, device=c.a.device)
    for v, d, s in zip((c.a, c.b), c.dims, c.strides):
        if v.is_floating_point():
            w = torch.round(v.double()).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
            k = torch.where(torch.isnan(w), 0.0, w).to(torch.int64)
        else:
            k = v.to(torch.int64)
            k = torch.where(k < 0, k + d, k)
        j += k.clamp(0, d - 1) * s
    return j


def _sources(idx: torch.Tensor, src_len: int):
    """(index as i64, valid) by ``jnp.take``'s rule."""
    j = idx.to(torch.int32).to(torch.int64)
    j = torch.where(j < 0, j + src_len, j)
    return j, (j >= 0) & (j < src_len)


def _fill(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


def fill_bits(dtype: torch.dtype) -> int:
    """The bits of the value an index out of range reads (the plain
    version's), as an unsigned integer."""
    size = _SIZE[dtype]
    bits = torch.tensor(_fill(dtype), dtype=dtype).view(_BITS[size]).item()
    return bits & ((1 << (8 * size)) - 1)


def gather_plain(out: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor) -> None:
    """``out[i] = src[idx[i]]`` by ``jnp.take``'s rule."""
    j, valid = _sources(idx, src.numel())
    fill = torch.tensor(_fill(out.dtype), dtype=out.dtype, device=out.device)
    if src.numel() == 0:
        out.copy_(fill.expand(out.shape))
        return
    v = src[torch.where(valid, j, torch.zeros_like(j))]
    out.copy_(torch.where(valid, v, fill))


def ranges_mirror(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                  plan: GatherPlan = None) -> Dict[str, torch.Tensor]:
    """The form on CPU tensors, step by step as its kernels take it, at
    any plan: (1) each tile's entries stably sorted by bucket (source
    range, out-of-range entries last), with the bucket-major matrix of the
    tiles' bucket starts (a last row of the tiles' lengths), each sorted
    entry's index within its range (0 out of range) and its destination's
    offset in the tile; (2) the sorted values, the fill in the last
    bucket; (3) each value at its offset.  The kernel
    orders a (tile, bucket) run by its shared-memory atomics, a warp at a
    time, the mirror by destination (stable).  Writes ``out`` and returns
    the intermediates (starts, sidx, soff, sval)."""
    n, src_len = idx.numel(), src.numel()
    if plan is None:
        plan = gather_plan(src_len, n, src.element_size())
    log_s, ranges, tile, tiles = plan[:4]
    j, valid = _sources(idx, src_len)
    bucket = torch.where(valid, j >> log_s, torch.full_like(j, ranges))
    # (1)
    tile_of = torch.arange(n) // tile
    order = torch.argsort(tile_of * (ranges + 1) + bucket, stable=True)
    counts = torch.bincount(tile_of * (ranges + 1) + bucket,
                            minlength=tiles * (ranges + 1)).view(
                                tiles, ranges + 1)
    starts = torch.zeros(ranges + 2, tiles, dtype=torch.int64)
    starts[1:] = torch.cumsum(counts, 1).t()
    j = torch.where(valid, j, torch.full_like(j, -1))[order]
    sidx = j.clamp(min=0) & ((1 << log_s) - 1)
    soff = order - tile_of[order] * tile
    # (2)
    fill = torch.tensor(_fill(src.dtype), dtype=src.dtype)
    sval = torch.where(j >= 0, src[j.clamp(min=0)] if src_len
                       else fill.expand(n), fill)
    # (3)
    out[tile_of[order] * tile + soff] = sval
    return {"starts": starts, "sidx": sidx, "soff": soff, "sval": sval}


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_gather")
    if not getattr(lib, "_vex_bound", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.vex_gather_ranges.argtypes = [
            ptr, ptr, i32, i32, ptr, i32, i64, ctypes.c_ulonglong, i32, i32,
            i32, i32, ptr, ptr, ptr, ptr, ptr]
        lib.vex_gather_coords.argtypes = [
            ptr, ptr, i32, i32, ptr, ptr, i32, i64, i64, i64, i32, i32, i64,
            ctypes.c_ulonglong, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        for f in (lib.vex_gather_ranges, lib.vex_gather_coords,
                  lib.vex_gather_max_ranges):
            f.restype = i32
        lib.vex_cuda_error_string.argtypes = [i32]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        if lib.vex_gather_max_ranges() != MAX_RANGES:
            raise RuntimeError("csrc/gather.cu's kMaxRanges differs from "
                               "cuda_gather.MAX_RANGES")
        lib._vex_bound = True
    return lib


def _check(out: torch.Tensor, src: torch.Tensor, keys, key_types,
           what: str = "indices") -> None:
    """The operands: ``keys`` (the index, or the coordinates) of
    ``key_types``, one an output element."""
    if out.dtype not in _SIZE:
        raise NotImplementedError(f"no gather kernel for {out.dtype}")
    if any(k.dtype not in key_types for k in keys):
        raise NotImplementedError(
            f"gather {what} are one of {[str(t) for t in key_types]}, not "
            f"{[str(k.dtype) for k in keys]}")
    if src.dtype != out.dtype:
        raise ValueError("gather: a source of the output's type")
    if any(t.ndim != 1 or not t.is_contiguous() for t in (out, src, *keys)) \
            or any(k.shape != out.shape for k in keys):
        raise ValueError(f"gather: contiguous 1-D output, {what} and "
                         "source, one an output element")
    if any(t.device != out.device for t in (src, *keys)):
        raise ValueError("gather operands on one device")
    if max(out.numel(), src.numel()) >= 1 << 31:
        raise NotImplementedError("the gather kernels take fewer than 2^31 "
                                  "elements")


_fill_bits: Dict[torch.dtype, int] = {}


def _launch(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
            plan: GatherPlan = None, keep: bool = False,
            coords: Coords = None):
    """The form's three launches on CUDA tensors, the index read from
    ``idx`` or computed from ``coords`` (the fused variant); with
    ``keep``, returns its scratch (starts, sidx, soff, sval)."""
    n, src_len = out.numel(), src.numel()
    size = src.element_size()
    if plan is None:
        plan = gather_plan(src_len, n, size)
    if not _fits(plan, size):
        raise NotImplementedError(f"the gather kernels do not take {plan}")
    bits = _fill_bits.get(out.dtype)
    if bits is None:
        bits = _fill_bits[out.dtype] = fill_bits(out.dtype)
    dev = out.device
    lib = _lib()
    # one allocation: the starts, the values, the offsets and the indices
    # (each part 16-byte aligned)
    cells = (plan.ranges + 2) * plan.tiles
    at_val = -(-4 * cells // 16) * 16
    at_off = at_val + -(-size * n // 16) * 16
    at_idx = at_off + -(-2 * n // 16) * 16
    scratch = torch.empty(at_idx + 2 * n, dtype=torch.uint8, device=dev)
    s = scratch.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    cut = (bits, plan.log_s, plan.ranges, plan.tile, plan.tiles, s,
           s + at_idx, s + at_off, s + at_val, stream)
    if coords is None:
        args = (out.data_ptr(), src.data_ptr(), size, src_len,
                idx.data_ptr(), int(idx.dtype == torch.int64), n, *cut)
        _raise(lib, _on(dev, lib.vex_gather_ranges, args), "gather_ranges")
    else:
        c = coords
        args = (out.data_ptr(), src.data_ptr(), size, src_len,
                c.a.data_ptr(), c.b.data_ptr(), COORD_TYPES[c.a.dtype],
                c.base, c.strides[0], c.strides[1], c.dims[0], c.dims[1], n,
                *cut)
        _raise(lib, _on(dev, lib.vex_gather_coords, args), "gather_coords")
    written(out)
    if not keep:
        return None
    return {"starts": scratch[:4 * cells].view(torch.int32).view(
                plan.ranges + 2, plan.tiles),
            "sidx": scratch[at_idx:].view(torch.int16),
            "soff": scratch[at_off:at_off + 2 * n].view(torch.int16),
            "sval": scratch[at_val:at_val + size * n].view(out.dtype)}


def gather_ranges(out: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> None:
    """``out[i] = src[idx[i]]`` by ``jnp.take``'s rule; see the module
    docstring."""
    _check(out, src, (idx,), (torch.int32, torch.int64))
    if out.device.type == "cpu":
        gather_plain(out, idx, src)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no gather kernel for {out.device}")
    if idx.numel() == 0:
        return
    if src.numel() == 0:
        raise NotImplementedError("no gather kernel for an empty source")
    _launch(out, idx, src)
    gather_ranges.launches += 1


#: calls that launched the form's kernels (not of the plain version)
gather_ranges.launches = 0


def _check_coords(out: torch.Tensor, c: Coords, src: torch.Tensor) -> None:
    if c.b.dtype != c.a.dtype:
        raise NotImplementedError("the fused gather takes coordinates of "
                                  "one type")
    _check(out, src, (c.a, c.b), tuple(COORD_TYPES), "coordinates")
    if min(c.dims) <= 0 or c.base < 0 or min(c.strides) < 0 or c.base + (
            c.dims[0] - 1) * c.strides[0] + (c.dims[1] - 1) * c.strides[1] \
            >= src.numel():
        raise ValueError(f"gather: coordinates {c.dims} at strides "
                         f"{c.strides} from {c.base} reach beyond the "
                         f"source's {src.numel()} elements")


def gather_coords(out: torch.Tensor, coords: Coords,
                  src: torch.Tensor) -> None:
    """``out[i] = src[j]``, j the flat index of ``coords`` (``Coords``; in
    range by construction): the fused variant, whose partition computes
    the index itself.  On a CPU tensor, the plain version
    (``coords_index`` and ``gather_plain``)."""
    _check_coords(out, coords, src)
    if out.device.type == "cpu":
        gather_plain(out, coords_index(coords), src)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no gather kernel for {out.device}")
    if out.numel() == 0:
        return
    _launch(out, None, src, coords=coords)
    gather_coords.launches += 1


#: calls that launched the fused variant's kernels
gather_coords.launches = 0
