"""reduce_by_key and the keyed scans: the CUDA kernel's wrappers and their
plain PyTorch versions.

Replaces ``vexcl_tpu/ops/pallas_rbk.py::_fused_kernel``
(``pallas_segscan_rowcompact``) and, for the keyed scans, the head-flag
pre-pass, ``pallas_segscan.py::_seg_kernel`` and the exclusive/init
epilogue of ``vexcl_tpu/ops/scan_by_key.py``.  The kernel,
``csrc/by_key.cuh``, is one template over the value type and the monoid
(add, max, min); a call is one single-pass launch with decoupled
look-back that computes the head flags from the keys itself, in the
order of combination of ``csrc/scan.cu``'s ``segscan`` (so the results
equal that kernel's bit for bit); its source note gives its design and
bound.

* ``reduce_by_key_apply(keys, vals, mono) -> (count, vals_out,
  keys_out)``: the total of every run of equal keys, in order, and each
  key vector's key at the run's tail; the count crosses to the host once
  (``int``), as the reference resizes its outputs there, and the outputs
  are the kernel's buffers sliced to it.  ``reduce_by_key_launch`` is the
  launch alone: the count stays on the device, nothing syncs.
* ``scan_by_key_apply(keys, x, mono, exclusive=False, init=None,
  out=None)``: the segmented inclusive scan; with ``init``, op(init,
  incl) at every element; exclusive, ``init`` (a literal 0 without one,
  for max and min too) at each head and op(init, incl[i - 1]) elsewhere.
  ``out`` may be x itself, not a key.
* ``by_key_tiled(...)``: the kernel's tile, window and (head, value,
  count) look-back in plain PyTorch at any tile and window size, for the
  tests (nothing on the main path calls it).

Keys: 1 to 7 vectors of 1, 2, 4 or 8 bytes.  Integer and bool keys
compare as integers; f16, bf16, f32 and f64 keys (and complex32/64, lane
by lane) as values: a NaN key starts a run of its own and -0.0 equals
+0.0, as ``k[:-1] == k[1:]`` does.  Values: f32, f64, i32, i64 and bf16
(carried in f32); integer sums wrap, MAX and MIN propagate NaN.  On a
CPU tensor the plain version runs; on a CUDA tensor the kernel launches,
and a type it does not cover raises.  The count ``launches`` on each
launching wrapper (``scan_by_key_apply``, ``reduce_by_key_launch``)
counts its kernel's launches (one per call).

The kernel's scratch (a status word and three 8-byte slots per tile, and
two counters; the words and counters left zeroed by
every launch) is kept per (device, stream) by
``cuda_scratch.StreamScratch``.  A call allocates its outputs (and
reduce_by_key its 0-d count), nothing else, and launches once.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .._build import written
from .cuda_compact import compact_plain
from .cuda_scan import (_DTYPE_CODE, _MONOIDS, _OPS, _carry_dtype,
                        _check_mono, _identity, segscan_plain)
from .cuda_scratch import StreamScratch

__all__ = ["reduce_by_key_apply", "reduce_by_key_launch", "scan_by_key_apply",
           "reduce_by_key_plain",
           "scan_by_key_plain", "by_key_tiled", "segment_heads",
           "scan_by_key_epilogue", "MAX_KEYS"]

#: key vectors a launch takes (csrc/by_key.cu ``kMaxKeys``)
MAX_KEYS = 7

#: tiles the scratch holds at least (2^24 f64 elements)
_MIN_TILES = 4096

#: float key kinds (csrc/by_key.cu ``KeyKind``); complex keys are two lanes
_KEY_KIND = {torch.float16: 1, torch.bfloat16: 2, torch.float32: 3,
             torch.float64: 4, torch.complex32: 1, torch.complex64: 3}
#: a float lane's bytes and +inf bits, by kind (the kernel's table)
_LANE = {1: (2, 0x7C00), 2: (2, 0x7F80), 3: (4, 0x7F800000),
         4: (8, 0x7FF0000000000000)}
_LOG2 = {1: 0, 2: 1, 4: 2, 8: 3}
_MODE_REDUCE = 4


#: the library that instantiates each value-type code: one a carry width,
#: built at once (csrc/by_key.cuh)
_LIBRARY = {0: "vexcl_by_key", 2: "vexcl_by_key", 1: "vexcl_by_key_wide",
            3: "vexcl_by_key_wide", 4: "vexcl_by_key_bf16"}


def _lib(code: int):
    from .._build import cuda_library

    lib = cuda_library(_LIBRARY[code])
    if not getattr(lib, "_vex_bound", False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.vex_by_key.argtypes = [i32, i32, i32, i32, ctypes.c_longlong,
                                   ptr, ptr, ptr, i64, ctypes.c_uint64,
                                   ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.vex_by_key.restype = i32
        lib.vex_by_key_tile.argtypes = [i32]
        lib.vex_by_key_tile.restype = lib.vex_by_key_window.restype = i32
        lib.vex_cuda_error_string.argtypes = [i32]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        #: elements per tile by dtype code, and tiles per look-back window
        lib.tiles = {c: lib.vex_by_key_tile(c) for c in _DTYPE_CODE.values()}
        lib.window = lib.vex_by_key_window()
        lib._vex_bound = True
    return lib


#: per (device, stream): a status word and three slots (value, count, last
#: value) a tile, and the counters
_scratch = StreamScratch(4, _MIN_TILES)


def _key_kind(dt: torch.dtype) -> Optional[int]:
    """The kernel's kind of a key type: 0 integer or bool, a float kind,
    or None where the kernel does not compare it."""
    if dt in _KEY_KIND:
        return _KEY_KIND[dt]
    if dt.is_floating_point or dt.is_complex:
        return None
    return 0


# -- plain versions ----------------------------------------------------------

def segment_heads(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bool head flags: element 0, and every element where a key vector
    differs from the element before (``k[:-1] == k[1:]``)."""
    n = keys[0].shape[0]
    device = keys[0].device
    eq = torch.ones(max(n - 1, 0), dtype=torch.bool, device=device)
    for k in keys:
        eq = eq & (k[:-1] == k[1:])
    head = torch.ones(min(n, 1), dtype=torch.bool, device=device)
    return torch.cat([head, ~eq])


def scan_by_key_epilogue(heads: torch.Tensor, incl: torch.Tensor, fn,
                         exclusive: bool, init) -> torch.Tensor:
    """The inclusive scan ``incl`` made the keyed scan's result: with
    ``init``, fn(init, incl); exclusive, init (0 without one) at each head
    and fn(init, incl[i - 1]) elsewhere, in incl's type."""
    iv = torch.tensor(0 if init is None else init, dtype=incl.dtype,
                      device=incl.device)
    if not exclusive:
        return incl if init is None else fn(iv.expand(incl.shape), incl)
    shifted = torch.cat([incl.new_zeros(1), incl[:-1]])
    rest = shifted if init is None else fn(iv.expand(shifted.shape), shifted)
    return torch.where(heads, iv.to(rest.dtype), rest)


def scan_by_key_plain(keys: Sequence[torch.Tensor], x: torch.Tensor,
                      mono: str, exclusive: bool = False,
                      init=None) -> torch.Tensor:
    """Head flags by tensor compares, ``segscan_plain``, the epilogue."""
    _check_mono(mono)
    if x.shape[0] == 0:
        return x.clone()
    heads = segment_heads(keys)
    incl = segscan_plain(heads, x, mono)
    return scan_by_key_epilogue(heads, incl, _OPS[mono], exclusive, init)


def reduce_by_key_plain(keys: Sequence[torch.Tensor], vals: torch.Tensor,
                        mono: str) -> Tuple[int, torch.Tensor,
                                            List[torch.Tensor]]:
    """(count, totals, tail keys): head flags by tensor compares,
    ``segscan_plain``, then ``compact_plain`` of the tails."""
    _check_mono(mono)
    if vals.shape[0] == 0:
        return 0, vals.clone(), [k.clone() for k in keys]
    heads = segment_heads(keys)
    tails = torch.cat([heads[1:], heads.new_ones(1)])
    incl = segscan_plain(heads, vals, mono)
    count, vals_c, *keys_c = compact_plain(tails, incl, *keys)
    m = int(count)
    return m, vals_c[:m], [k[:m] for k in keys_c]


def _key_bits(k: torch.Tensor) -> torch.Tensor:
    """A key tensor's bits, one int64 an element (unsigned below 8 bytes)."""
    w = k.element_size()
    b = k.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[w]).to(torch.int64)
    return b if w in (1, 8) else b & ((1 << (8 * w)) - 1)


def _kernel_neq(k: torch.Tensor) -> torch.Tensor:
    """neq[e - 1]: element e's key differs from element e - 1's, by the
    kernel's formula on the bits (integers as bits; a float lane equal
    where its bits are equal and not NaN, or both are zero up to the
    sign)."""
    kind = _key_kind(k.dtype)
    if kind is None:
        raise NotImplementedError(f"no key comparison for {k.dtype}")
    b = _key_bits(k)
    a, c = b[1:], b[:-1]
    if kind == 0:
        return a != c
    lane, inf = _LANE[kind]
    bits = 8 * lane
    lmask = -1 if bits == 64 else (1 << bits) - 1
    mag = (1 << (bits - 1)) - 1
    eq = torch.ones_like(a, dtype=torch.bool)
    for s in range(0, 8 * k.element_size(), bits):
        x, y = (a >> s) & lmask, (c >> s) & lmask
        eq &= torch.where(x == y, (x & mag) <= inf, ((x | y) & mag) == 0)
    return ~eq


def by_key_tiled(keys: Sequence[torch.Tensor], x: torch.Tensor,
                 mono: str = "add", tile: int = 8192, window: int = 256,
                 shift: int = 0, exclusive: bool = False, init=None):
    """The kernel's decomposition in plain PyTorch, one element at a time,
    on CPU tensors: (y, count, totals, tail keys), y the keyed scan
    (``exclusive``, ``init``) and the rest reduce_by_key.  Head flags by
    the kernel's comparison of bits; ``shift`` identity elements stand
    before x, as the kernel's alignment shift puts them; tiles of ``tile``
    positions each fold (head seen, value, tails) triples, and tile t in
    window [b, b + window) takes as its prefix P(b - 1) . F, F the fold,
    in order, of AGG(b) ... AGG(t - 1), where P(t) = prefix(t) . AGG(t)
    for the tile that ends a window; a run's total goes to slot (tails
    before the tile) + (rank in the tile); the exclusive scans read the
    previous position's inclusive value, across a tile's start too, as
    the kernel does.  The within-tile bracketing is sequential, not the
    kernel's: float sums agree with it up to rounding, and with
    ``scan_tiled`` of the same heads bit for bit.  For the tests only:
    nothing on the main path calls it."""
    _check_mono(mono)
    keys = tuple(keys)
    n = x.shape[0]
    op = _OPS[mono]
    xc = x.to(_carry_dtype(x.dtype))
    ident = _identity(mono, xc.dtype)
    heads = [True] + [False] * (n - 1)
    for k in keys:
        for i, d in enumerate(_kernel_neq(k).tolist()):
            heads[i + 1] = heads[i + 1] or d
    tails = heads[1:] + [True]
    iv = torch.tensor(0 if init is None else init, dtype=x.dtype)
    ivc = iv.to(xc.dtype)

    def stored(v):               # a carry value rounded through x's type
        return v.to(x.dtype).to(xc.dtype)

    def comb(a, b):              # (head seen, value, tails); a the earlier
        return (a[0] or b[0], b[1] if b[0] else op(a[1], b[1]), a[2] + b[2])

    # (head, value, tail, element or None) a position
    pos = [(False, ident, False, None)] * shift + [
        (heads[e], xc[e], tails[e], e) for e in range(n)]
    pos += [(False, ident, False, None)] * (-len(pos) % tile)
    tiles = [pos[i:i + tile] for i in range(0, len(pos), tile)]
    agg = []
    for els in tiles:
        acc = (False, ident, 0)
        for h, v, t, _ in els:
            acc = comb(acc, (h, v, int(t)))
        agg.append(acc)
    ends = {}
    y = [None] * n
    slots = {}                   # slot -> (total, the tail's element)
    zero = torch.zeros((), dtype=xc.dtype)
    last = (False, ident, 0)     # the previous position's inclusive value
    for t, els in enumerate(tiles):
        b = t - t % window
        prefix = ends[b - 1] if b > 0 else (False, ident, 0)
        if t > b:
            f = agg[b]
            for a in agg[b + 1:t]:
                f = comb(f, a)
            prefix = comb(prefix, f)
        if t % window == window - 1:
            ends[t] = comb(prefix, agg[t])
        run, rank = prefix, 0
        for h, v, tl, e in els:
            prev = last
            run = last = comb(run, (h, v, 0))
            if e is None:
                continue
            if not exclusive:
                y[e] = run[1] if init is None else op(ivc, stored(run[1]))
            elif h:
                y[e] = zero if init is None else ivc
            else:
                y[e] = prev[1] if init is None else op(ivc, stored(prev[1]))
            if tl:
                slots[prefix[2] + rank] = (run[1], e)
                rank += 1
    count = len(slots)
    ordered = [slots[i] for i in range(count)]     # every slot, once
    out = torch.stack(y).to(x.dtype) if n else x.clone()
    vals = (torch.stack([v for v, _ in ordered]).to(x.dtype) if count
            else x[:0].clone())
    idx = torch.tensor([e for _, e in ordered], dtype=torch.long)
    return out, count, vals, [k[idx] for k in keys]


# -- the kernel's wrappers -----------------------------------------------------

def _check_operands(keys, x, what: str):
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"{what}: 1 to {MAX_KEYS} key vectors, not "
                         f"{len(keys)}")
    if x.ndim != 1 or any(k.shape != x.shape for k in keys):
        raise ValueError(f"{what}: keys and values must be 1-D tensors of "
                         "one length")


def _ranges_overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    pa, pb = a.data_ptr(), b.data_ptr()
    return (pa < pb + b.numel() * b.element_size()
            and pb < pa + a.numel() * a.element_size())


def _key_codes(keys, device) -> int:
    """The keys' 5-bit codes packed for ``vex_by_key``; raises on a key
    the kernel does not compare or on another device."""
    codes = 0
    for q, k in enumerate(keys):
        kind = _key_kind(k.dtype)
        lw = _LOG2.get(k.element_size())
        if kind is None or lw is None:
            raise NotImplementedError(f"keyed kernel has no comparison for "
                                      f"{k.dtype} keys")
        if k.device != device or not k.is_contiguous():
            raise ValueError("keys must be contiguous tensors on the "
                             "values' device")
        codes |= (lw | kind << 2) << (5 * q)
    return codes


def _init_bits(init, dt: torch.dtype) -> int:
    """init in x's type, then in the carry type, as unsigned bits."""
    if init is None:
        return 0
    c = torch.tensor(init, dtype=dt).to(_carry_dtype(dt))
    size = c.element_size()
    bits = int(c.view(torch.int32 if size == 4 else torch.int64))
    return bits & ((1 << (8 * size)) - 1)


def _launch(code: int, mono: str, mode: int, keys, outs, x: torch.Tensor,
            y: torch.Tensor, init: int, count: Optional[torch.Tensor],
            what: str) -> None:
    """One launch of ``vex_by_key`` on x's device and current stream, with
    that stream's scratch; raises if the launch was refused."""
    device = x.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = _lib(code)
    n = x.shape[0]
    codes = _key_codes(keys, x.device)
    # the raw stream handle (~0.1 us; a Stream object costs ~3 us)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    words, counters = _scratch.get(device, stream,
                                   -(-(n + 15) // lib.tiles[code]))
    base, step = words.data_ptr(), words.stride(0) * 8
    ts = (*keys, *outs)
    ptrs = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    args = (code, _MONOIDS[mono], mode, len(keys), codes, ptrs,
            x.data_ptr(), y.data_ptr(), n, init,
            None if count is None else count.data_ptr(), base, base + step,
            base + 2 * step, base + 3 * step, counters.data_ptr(), stream)
    if torch.cuda.current_device() == device.index:
        rc = lib.vex_by_key(*args)
    else:
        with torch.cuda.device(device):
            rc = lib.vex_by_key(*args)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())


def _value_code(x: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise NotImplementedError(f"{what} kernel has no form for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} values must be contiguous")
    return code


def scan_by_key_apply(keys: Sequence[torch.Tensor], x: torch.Tensor,
                      mono: str = "add", exclusive: bool = False, init=None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The keyed scan of the 1-D ``x`` over runs of equal ``keys`` (a
    sequence of key tensors), written to ``out`` when given (``out`` may
    be ``x``; see the module docstring)."""
    _check_mono(mono)
    keys = tuple(keys)
    _check_operands(keys, x, "keyed scan")
    if x.device.type == "cpu":
        y = scan_by_key_plain(keys, x, mono, exclusive, init)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no keyed scan kernel for {x.device}")
    code = _value_code(x, "keyed scan")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("keyed scan: out must be a contiguous tensor like x")
    if any(_ranges_overlap(out, k) for k in keys) or (
            out.data_ptr() != x.data_ptr() and _ranges_overlap(out, x)):
        raise ValueError("keyed scan: out may be x, and must not overlap "
                         "a key or a part of x")
    if x.shape[0] == 0:
        return out
    mode = (2 if exclusive else 0) + (init is not None)
    _launch(code, mono, mode, keys, (), x, out, _init_bits(init, x.dtype),
            None, "keyed scan")
    written(out)
    scan_by_key_apply.launches += 1
    return out


def reduce_by_key_launch(keys: Sequence[torch.Tensor], vals: torch.Tensor,
                         mono: str = "add") -> Tuple[torch.Tensor, ...]:
    """(count, totals, *tail keys) of the runs of equal ``keys``, without
    a sync: ``count`` a 0-d int64 tensor on the device, each output of
    the inputs' length, its first ``count`` entries the results (the rest
    undefined), as ``compact_apply`` gives them."""
    _check_mono(mono)
    keys = tuple(keys)
    _check_operands(keys, vals, "reduce_by_key")
    if vals.device.type == "cpu":
        heads = segment_heads(keys)
        tails = torch.cat([heads[1:], heads.new_ones(1)])
        return compact_plain(tails, segscan_plain(heads, vals, mono), *keys)
    if vals.device.type != "cuda":
        raise NotImplementedError(f"no reduce_by_key kernel for "
                                  f"{vals.device}")
    code = _value_code(vals, "reduce_by_key")
    totals = torch.empty_like(vals)
    keys_out = [torch.empty_like(k) for k in keys]
    if vals.shape[0] == 0:
        return (torch.zeros((), dtype=torch.int64, device=vals.device),
                totals, *keys_out)
    count = torch.empty((), dtype=torch.int64, device=vals.device)
    _launch(code, mono, _MODE_REDUCE, keys, keys_out, vals, totals, 0,
            count, "reduce_by_key")
    reduce_by_key_launch.launches += 1
    return (count, totals, *keys_out)


def reduce_by_key_apply(keys: Sequence[torch.Tensor], vals: torch.Tensor,
                        mono: str = "add") -> Tuple[int, torch.Tensor,
                                                    List[torch.Tensor]]:
    """(count, totals, tail keys) of the runs of equal ``keys``: one
    ``reduce_by_key_launch``, then the count crosses to the host once and
    the outputs are sliced to it."""
    if vals.device.type == "cpu":
        keys = tuple(keys)
        _check_operands(keys, vals, "reduce_by_key")
        return reduce_by_key_plain(keys, vals, mono)
    count, totals, *keys_out = reduce_by_key_launch(keys, vals, mono)
    m = int(count)          # the one host sync (the reference resizes too)
    return m, totals[:m], [k[:m] for k in keys_out]


#: launches of the CUDA kernel (not of the plain versions)
scan_by_key_apply.launches = 0
reduce_by_key_launch.launches = 0
