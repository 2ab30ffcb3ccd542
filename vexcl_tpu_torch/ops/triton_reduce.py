"""The map-reduce kernel (Triton): SUM, MIN, MAX or compensated SUM of
one or several expressions, several accumulators in one pass.

Replaces ``vexcl_tpu/ops/pallas_reduce.py::_kernel`` (called through
``pallas_map_reduce``) and, for several (body, kind) pairs, the one XLA
reduction ``vexcl_tpu/ops/reductor.py`` traces over all kinds of a
``CombineReductors`` and the components of a multivector.  On the TPU the
grid runs in order on one core, so that kernel carries one running total
in SMEM from block to block.  CUDA blocks run at the same time and in no
order; here one persistent launch does the whole reduction,
deterministic and without atomics on the data:

1. the grid is ``min(cdiv(n, BLOCK), SMs x PROGRAMS_PER_SM)`` programs.
   Program p walks tiles p, p + grid, p + 2 grid, ... (``tl.range``,
   ``num_stages=REDUCE_STAGES``), evaluates the expression bodies that
   ``expr/triton_emit.py`` generates for the assignment kernel (a node
   shared by several bodies, or one body under several kinds, once),
   replaces the tail lanes by each accumulator's identity AFTER the map
   (as ``pallas_reduce.py`` does: ``sum(exp(x))`` must not count
   ``exp(0)`` for padded lanes), and folds the tile into one
   ``BLOCK``-wide accumulator per (body, kind) in registers, which it
   reduces once at the end and stores as its partials;
2. each program then draws a ticket (``tl.atomic_add``, acq_rel at GPU
   scope); the one that draws the last ticket reads every partial past L1
   (``volatile``), combines them in program order, writes the results and
   sets the ticket back to 0.

A complex SUM keeps two accumulators, the real and the imaginary parts
(f32 for c64, f64 for c128), each its own partial word, and its result
is the (re, im) pair; MIN and MAX of complex values raise on CUDA (jnp
orders complex values lexicographically, the kernel does not), as does
a compensated complex sum.

``SUM_Kahan`` keeps a compensated pair (s, c) per lane (y = v - c,
t = s + y, c = (t - s) - y, s = t; no multiply, so nothing contracts to
an FMA, and Triton does not reassociate), and the per-program reduction
and the final combine join pairs with an error-free two-sum, so the
lanes' compensation survives to the result, s - c.

Tiles belong to programs in a fixed way and the partials combine in a
fixed order, so a result is the same bits from call to call on one card.
Each partial is one 8-byte word (a Kahan pair two) of a scratch of
(words, grid) int64 words, allocated once per (device, stream, words):
keyed by stream, two reductions enqueued on two streams never share a
ticket.  One result comes back as a 0-d tensor of its type, several as
one int64 word each; only that tensor is allocated per call.

Accumulation is in f32 for f32 (and 16-bit) values, as ``acc_dtype`` in
the JAX kernel, in f64 for f64 and in i64 (u64) for integer SUM (Kahan of
integers is their exact sum).  The kernel serves every size: the TPU's
``n >= 2*BLOCK`` threshold was a TPU choice.  It is bound by device
memory bandwidth: one read of each leaf, e.g. 134 MB for ``Sum(p*Ap)`` at
2^24 f32, 0.0401 ms at 3.35 TB/s, and 67 MB for ``MIN_MAX(x)``, 0.0200
ms.  BLOCK shrinks from 4096 as the words grow, so that the
accumulators stay in registers, and halves where a complex value is
summed, whose loads carry two values an element (2^24 c64 on an H100:
0.0564 ms with tiles of 4096 elements, 0.0492 with 2048, beside
``torch.sum``'s 0.0504; ``scripts/torch_complex_variants.py``).  MIN
and MAX propagate NaN, as ``jnp.min`` and ``jnp.max`` do: both the
per-program and the final combine use ``tl.minimum`` / ``tl.maximum``
under ``propagate_nan=ALL`` (``tl.min`` and ``tl.max`` drop NaN).  Tail
lanes still hold the identity, +-inf.

``map_reduce`` (one pair) and ``map_reduce_multi`` are the wrappers: the
kernel for CUDA tensors, the plain PyTorch reductions of the trees'
``emit`` forms for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .._build import Pointer
from ..cache import kernel_cache
from ..config import config
from ..expr.node import Analysis, Expr
from ..expr.triton_emit import (_HEADER, _NAN_ALL, _Launches, body,
                                jit_header, kernel_key, launch_args,
                                plain_values, tl_type)
from ..types import COMPLEX_CODES, dtype_of_code, real_code

__all__ = ["map_reduce", "map_reduce_plain", "map_reduce_multi",
           "map_reduce_multi_plain", "min_max_plain", "reduce_source", "reduce_multi_source",
           "acc_code", "kahan_sum_plain", "map_reduce_complex",
           "REDUCE_BLOCK"]

#: elements per tile (per program per grid-stride step) of one or two
#: accumulator words; halved for every doubling of the words past two
REDUCE_BLOCK = 4096
REDUCE_WARPS = 8
#: programs per SM in the persistent grid
PROGRAMS_PER_SM = 4
#: ``num_stages`` of the tile loop.  1: no software pipelining.  At four
#: programs of 8 warps per SM the loads in flight already keep device
#: memory busy, and a trial on the H100 found 3 stages no faster; 1 needs
#: no shared memory however many leaves the expression has.
REDUCE_STAGES = 1
#: partials combined per step by the last program
FINAL_BLOCK = 1024

KINDS = ("SUM", "MIN", "MAX", "SUM_Kahan")


def acc_code(kind: str, code: str, kernel: bool = True) -> str:
    """Accumulator type of a reduction over values of type ``code``; with
    ``kernel``, raise on what the CUDA kernel does not cover (complex MIN,
    MAX and compensated sums, MIN/MAX of booleans), which the plain forms
    compute in the value's own type."""
    dt = dtype_of_code(code)
    if dt.is_complex:
        if kernel and kind != "SUM":
            raise NotImplementedError(
                f"{kind} of complex values is not covered by the CUDA "
                "map-reduce kernel")
        return "c128" if code == "c*" else code
    if dt.is_floating_point:
        return "f64" if dt == torch.float64 else "f32"
    if kind in ("SUM", "SUM_Kahan"):
        return "u64" if dt == torch.uint64 else "i64"
    if dt == torch.bool and kernel:
        raise NotImplementedError("MIN/MAX of booleans is not covered by the "
                                  "CUDA map-reduce kernel")
    return code


def _identity(kind: str, code: str) -> str:
    if kind in ("SUM", "SUM_Kahan"):
        return "0"
    dt = dtype_of_code(code)
    if dt.is_floating_point:
        return "float('inf')" if kind == "MIN" else "float('-inf')"
    info = torch.iinfo(dt)
    return str(info.max if kind == "MIN" else info.min)


_COMBINES = f"""@triton.jit
def min_nan(a, b):
    return tl.minimum(a, b, {_NAN_ALL})


@triton.jit
def max_nan(a, b):
    return tl.maximum(a, b, {_NAN_ALL})


@triton.jit
def min_int(a, b):
    return tl.minimum(a, b)


@triton.jit
def max_int(a, b):
    return tl.maximum(a, b)


@triton.jit
def kahan(s1, c1, s2, c2):
    # two compensated sums (true value s - c) joined by an error-free
    # two-sum: s1 + s2 == t + e exactly
    t = s1 + s2
    bp = t - s1
    e = (s1 - (t - bp)) + (s2 - bp)
    return t, (c1 + c2) - e


"""


def _block(words: int) -> int:
    """Tile length for ``words`` accumulator words a lane."""
    return max(512, REDUCE_BLOCK >> max(0, (words - 1).bit_length() - 1))


def _words(layout: Sequence[Tuple[str, str]]) -> int:
    """Partial words a program of the (kind, accumulator) pairs: two for
    a compensated or a complex sum."""
    return sum(2 if k == "SUM_Kahan" or a in COMPLEX_CODES else 1
               for k, a in layout)


def _result_offsets(accs: Sequence[str]):
    """(each result's first 8-byte word, the words of all): one word a
    result, two for c128, at an even word (where a c128 view of the words
    can start)."""
    offsets, w = [], 0
    for a in accs:
        if a == "c128":
            w += w % 2
        offsets.append(w)
        w += 2 if a == "c128" else 1
    return offsets, w


def _layout(pairs: Sequence[Tuple[Expr, str]], types: Dict[int, str],
            kernel: bool = True):
    """(kind, accumulator code) of each pair, Kahan of integers as SUM
    (``kernel``: see ``acc_code``)."""
    out = []
    for e, kind in pairs:
        if kind not in KINDS:
            raise ValueError(f"unknown reduction kind {kind!r}")
        acc = acc_code(kind, types[id(e)], kernel)
        if kind == "SUM_Kahan" and not dtype_of_code(acc).is_floating_point:
            kind = "SUM"            # Kahan of integers: their exact sum
        out.append((kind, acc))
    return out


def reduce_multi_source(pairs: Sequence[Tuple[Expr, str]],
                        analysis: Analysis, types: Dict[int, str]) -> str:
    """The kernel reducing each (body, kind) pair of ``pairs`` to one
    result word of ``out_ptr``; bodies may repeat (``MIN_MAX``)."""
    layout = _layout(pairs, types)
    lines, res = body([e for e, _ in pairs], analysis, types,
                      [acc for _, acc in layout])
    init, update, store, final, fold, result = [], [], [], [], [], []
    offsets, _ = _result_offsets([acc for _, acc in layout])
    w = 0
    for a, ((kind, acc), r) in enumerate(zip(layout, res)):
        wo = offsets[a]
        if acc in COMPLEX_CODES:
            # a complex SUM: an accumulator, a partial word and a result
            # part each for re and im
            tl_t = tl_type(real_code(acc))
            for part, rv in enumerate(r):
                name, pw = f"a{a}_{part}", w + part
                ptr = (f"(part_ptr + {pw} * stride)"
                       f".to(tl.pointer_type({tl_t}))")
                init.append(f"{name} = tl.zeros([BLOCK], {tl_t})")
                update.append(f"{name} = {name} + tl.where(mask, {rv}, 0)")
                store.append(f"tl.store({ptr} + pid, tl.sum({name}, axis=0))")
                final.append(f"f{name} = tl.zeros([FINAL], {tl_t})")
                fold.append(f"f{name} = f{name} + tl.load({ptr} + o, "
                            "mask=o < nprog, other=0, volatile=True)")
                result.append(f"tl.store((out_ptr + {wo})"
                              f".to(tl.pointer_type({tl_t})) + {part}, "
                              f"tl.sum(f{name}, axis=0))")
            w += 2
            continue
        tl_t, idv = tl_type(acc), _identity(kind, acc)
        ptr = f"(part_ptr + {w} * stride).to(tl.pointer_type({tl_t}))"
        init.append(f"a{a} = tl.full([BLOCK], {idv}, {tl_t})")
        v = f"tl.where(mask, {r}, {idv})"
        if kind == "SUM_Kahan":
            cptr = (f"(part_ptr + {w + 1} * stride)"
                    f".to(tl.pointer_type({tl_t}))")
            init.append(f"c{a} = tl.zeros([BLOCK], {tl_t})")
            update += [f"y{a} = {v} - c{a}", f"u{a} = a{a} + y{a}",
                       f"c{a} = (u{a} - a{a}) - y{a}", f"a{a} = u{a}"]
            store += [f"ps{a}, pc{a} = tl.reduce((a{a}, c{a}), 0, kahan)",
                      f"tl.store({ptr} + pid, ps{a})",
                      f"tl.store({cptr} + pid, pc{a})"]
            final.append(f"fs{a} = tl.zeros([FINAL], {tl_t})")
            final.append(f"fc{a} = tl.zeros([FINAL], {tl_t})")
            fold += [f"fs{a}, fc{a} = kahan(fs{a}, fc{a}, "
                     f"tl.load({ptr} + o, mask=o < nprog, other=0, "
                     "volatile=True), "
                     f"tl.load({cptr} + o, mask=o < nprog, other=0, "
                     "volatile=True))"]
            result += [f"rs{a}, rc{a} = tl.reduce((fs{a}, fc{a}), 0, kahan)",
                       f"tl.store((out_ptr + {wo})"
                       f".to(tl.pointer_type({tl_t})), rs{a} - rc{a})"]
            w += 2
            continue
        if kind == "SUM":
            comb, red = "{} + {}", "tl.sum({}, axis=0)"
        else:
            fn = ("min" if kind == "MIN" else "max") + (
                "_nan" if dtype_of_code(acc).is_floating_point else "_int")
            comb, red = fn + "({}, {})", "tl.reduce({}, 0, " + fn + ")"
        update.append(f"a{a} = {comb.format(f'a{a}', v)}")
        store.append(f"tl.store({ptr} + pid, {red.format(f'a{a}')})")
        final.append(f"f{a} = tl.full([FINAL], {idv}, {tl_t})")
        fold.append(f"f{a} = " + comb.format(
            f"f{a}", f"tl.load({ptr} + o, mask=o < nprog, other={idv}, "
            "volatile=True)"))
        result.append(f"tl.store((out_ptr + {wo})"
                      f".to(tl.pointer_type({tl_t})), "
                      f"{red.format(f'f{a}')})")
        w += 1

    def block(stmts, indent):
        return [" " * indent + st + "\n" for st in stmts]
    src = [_HEADER, _COMBINES,
           jit_header("reduce_kernel", analysis,
                      ["part_ptr", "ticket_ptr", "out_ptr"],
                      ["n", "ntiles", "stride", "BLOCK: tl.constexpr",
                       "FINAL: tl.constexpr"]),
           "    pid = tl.program_id(0)\n",
           "    nprog = tl.num_programs(0)\n"]
    src += block(init, 4)
    src += ["    for tile in tl.range(pid, ntiles, nprog, "
            f"num_stages={REDUCE_STAGES}):\n",
            "        offs = tile.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)\n",
            "        mask = offs < n\n"]
    src += block(lines, 8) + block(update, 8) + block(store, 4)
    src += ["    tl.debug_barrier()\n",
            "    ticket = tl.atomic_add(ticket_ptr, 1, sem='acq_rel', "
            "scope='gpu')\n",
            "    if ticket == nprog - 1:\n"]
    src += block(final, 8)
    src += ["        for start in range(0, nprog, FINAL):\n",
            "            o = start + tl.arange(0, FINAL)\n"]
    src += block(fold, 12) + block(result, 8)
    src.append("        tl.store(ticket_ptr, 0)\n")
    return "".join(src)


def reduce_source(expr: Expr, analysis: Analysis, types: Dict[int, str],
                  kind: str) -> str:
    return reduce_multi_source([(expr, kind)], analysis, types)


#: (device index, stream, words) -> (partials, ticket)
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
#: entries kept; past it the oldest is freed (see ``cuda_scratch``)
_MAX_ENTRIES = 64
#: device index -> its SMs (an int key: hashing a torch.device costs more)
_sm_count: Dict[int, int] = {}


def _programs(device: torch.device) -> int:
    """The persistent grid's ceiling on ``device``."""
    sms = _sm_count.get(device.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = sms
    return sms * PROGRAMS_PER_SM


def _scratch_for(device: torch.device, words: int):
    """The (words, largest grid) partial words and the zeroed ticket of
    the current stream on ``device`` (an indexed CUDA device), allocated
    at first use."""
    # the raw stream handle, as Triton's launcher reads it: ~0.1 us where
    # torch.cuda.current_stream() builds a Stream object (~3 us a call)
    idx = device.index
    key = (idx, torch._C._cuda_getCurrentRawStream(idx), words)
    s = _scratch.get(key)
    if s is None:
        s = (torch.empty(words, _programs(device), dtype=torch.int64,
                         device=device),
             torch.zeros(1, dtype=torch.int32, device=device))
        _scratch[key] = s
        while len(_scratch) > _MAX_ENTRIES:
            del _scratch[next(iter(_scratch))]
    return s


class _ReduceKernel:
    """The kernel cache's entry: the launcher (``_build.TritonLauncher``)
    and what depends on the key alone (accumulator types, words, tile,
    constexpr values)."""

    def __init__(self, src: str, accs: Sequence[str], words: int):
        from .._build import TritonLauncher, triton_module

        if config.show_kernels:
            print(src)
        self.accs = [dtype_of_code(a) for a in accs]
        self.words = words
        #: the kernel sums a complex value (its launches count on
        #: ``map_reduce_complex``)
        self.complex = any(a in COMPLEX_CODES for a in accs)
        self.block = max(512, _block(words) // (2 if self.complex else 1))
        self.consts = (self.block, FINAL_BLOCK)
        #: each result's first 8-byte word, and the words of all
        self.offsets, self.out_words = _result_offsets(accs)
        #: the results' one real type and its stride in the 8-byte words,
        #: or None where they have several types or a complex one
        one_type = len(set(self.accs)) == 1 and not self.complex
        self.stride = 8 // self.accs[0].itemsize if one_type else None
        self.launcher = TritonLauncher(triton_module(src).reduce_kernel,
                                       REDUCE_WARPS)

    def launch(self, leaves: Sequence, n: int, device):
        ntiles = -(-n // self.block)
        nprog = min(ntiles, _programs(device))
        part, ticket = _scratch_for(device, self.words)
        # one result: a 0-d tensor of its type; several: an 8-byte word
        # each, at the start of which the kernel stores its result
        k = len(self.accs)
        # new_empty on the scratch: no device argument to parse
        if k == 1:
            out = part.new_empty((), dtype=self.accs[0])
            arg = Pointer(out, out.dtype.to_real()) if self.complex else out
        elif self.stride is not None:
            # one type: the words as (k, 8 / itemsize) values of it, whose
            # first column is read back as one view (no view a result)
            out = part.new_empty((k, self.stride), dtype=self.accs[0])
            arg = Pointer(out, torch.int64)
        else:
            out = arg = part.new_empty(self.out_words)
        self.launcher((nprog,), [part, ticket, arg, *launch_args(leaves)],
                      (n, ntiles, part.shape[1]), self.consts, device)
        if k == 1:
            return [out]
        if self.stride is not None:
            return out.select(1, 0)
        # each result at the start of its words
        return [out[o:o + max(1, dt.itemsize // 8)].view(dt)[0]
                for o, dt in zip(self.offsets, self.accs)]


def kahan_sum_plain(x: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Compensated summation: chunk partials + Kahan over the partials
    (the JAX package's ``_kahan_sum``)."""
    n = x.shape[0]
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    partials = x.reshape(-1, chunk).sum(dim=1)
    s = torch.zeros((), dtype=x.dtype, device=x.device)
    c = torch.zeros((), dtype=x.dtype, device=x.device)
    for p in partials:
        y = p - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def map_reduce_multi_plain(pairs: Sequence[Tuple[Expr, str]],
                           analysis: Analysis, types, leaves, n: int,
                           device) -> List[torch.Tensor]:
    """The kernel's plain PyTorch version: the per-kind reductions (also
    of what the kernel does not cover: complex sums, MIN/MAX of
    booleans)."""
    layout = _layout(pairs, types, kernel=False)
    vals = plain_values([e for e, _ in pairs], analysis, types, leaves, n,
                        device)
    out = []
    for val, (kind, acc) in zip(vals, layout):
        if kind in ("SUM", "SUM_Kahan"):
            dt = dtype_of_code(acc)
            s = (torch.sum if kind == "SUM" else kahan_sum_plain)(val.to(dt))
            # the CPU sums u64 words into i64: the same bits
            out.append(s.view(dt) if s.dtype != dt else s)
        else:
            out.append(min_max_plain(val, kind == "MIN"))
    return out


def min_max_plain(val: torch.Tensor, least: bool, dim=None) -> torch.Tensor:
    """``amin``/``amax`` (over ``dim``, or all), NaN propagated; unsigned
    values, which the CPU's kernels do not order, in a signed carrier:
    u16/u32 in i64, u64 in i64 with the sign bit flipped; complex values
    in numpy's lexicographic order (the real parts, then the imaginary
    parts of the values whose real part is the extreme one)."""
    fn = torch.amin if least else torch.amax
    kw = {} if dim is None else {"dim": dim}
    if val.is_complex():
        re, im = val.real, val.imag
        top = fn(re, **kw)
        at = re == (top if dim is None else fn(re, dim=dim, keepdim=True))
        far = float("inf") if least else float("-inf")
        side = fn(torch.where(at, im, torch.full_like(im, far)), **kw)
        return torch.complex(top, side)
    if val.dtype == torch.uint64:
        flip = -(1 << 63)
        return (fn(val.view(torch.int64) ^ flip, **kw) ^ flip).view(
            torch.uint64)
    if val.dtype in (torch.uint16, torch.uint32):
        return fn(val.to(torch.int64), **kw).to(val.dtype)
    return fn(val, **kw)


def map_reduce_plain(expr: Expr, analysis: Analysis, types, leaves, n: int,
                     kind: str, device) -> torch.Tensor:
    """The one-pair kernel's plain PyTorch version."""
    return map_reduce_multi_plain([(expr, kind)], analysis, types, leaves, n,
                                  device)[0]


def _reduce(pairs: Sequence[Tuple[Expr, str]], shape: tuple,
            analysis: Analysis, types, leaves, n: int,
            device: torch.device) -> List[torch.Tensor]:
    """Launch the kernel of ``pairs``, whose (body number, kind) tuple
    ``shape`` is its cache key with the analysis: (the kernel, its
    results)."""
    if device.type != "cuda":
        raise NotImplementedError(f"no map-reduce kernel for {device}")
    if n == 0:
        raise ValueError("reduction over an empty expression")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = ("reduce", shape) + kernel_key(analysis, None)

    def factory():
        layout = _layout(pairs, types)
        return _ReduceKernel(reduce_multi_source(pairs, analysis, types),
                             [acc for _, acc in layout], _words(layout))

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    return k, k.launch(leaves, n, device)


def map_reduce(expr: Expr, analysis: Analysis, types, leaves, n: int,
               kind: str, device: torch.device) -> torch.Tensor:
    """Reduce the elementwise ``expr`` over ``n`` elements to a 0-d
    tensor on ``device``."""
    if kind not in KINDS:
        raise ValueError(f"unknown reduction kind {kind!r}")
    if device.type == "cpu":
        return map_reduce_plain(expr, analysis, types, leaves, n, kind,
                                device)
    k, res = _reduce([(expr, kind)], ((0, kind),), analysis, types, leaves,
                     n, device)
    if k.complex:
        map_reduce_complex.launches += 1
    else:
        map_reduce.launches += 1
    return res[0]


#: launches of the one-pair map-reduce kernel that sum no complex value
#: (not of its plain version)
map_reduce.launches = 0


def map_reduce_multi(pairs: Sequence[Tuple[Expr, str]], analysis: Analysis,
                     types, leaves, n: int, device: torch.device):
    """Reduce each (elementwise body, kind) of ``pairs`` over ``n``
    elements in one launch: a sequence of 0-d tensors on ``device`` (a
    list, or on the card a 1-D tensor where the results share a type)."""
    if device.type == "cpu":
        return map_reduce_multi_plain(pairs, analysis, types, leaves, n,
                                      device)
    first: Dict[int, int] = {}
    shape = tuple((first.setdefault(id(e), len(first)), kind)
                  for e, kind in pairs)
    k, res = _reduce(pairs, shape, analysis, types, leaves, n, device)
    if k.complex:
        map_reduce_complex.launches += 1
    else:
        map_reduce_multi.launches += 1
    return res


#: launches of the several-pair kernel that sum no complex value (not of
#: its plain version)
map_reduce_multi.launches = 0


#: launches of ``map_reduce`` and ``map_reduce_multi`` whose kernel sums a
#: complex value, (re, im) accumulators (not of their plain versions)
map_reduce_complex = _Launches()
