"""V2: the reduction of a view over some of its axes (``reduce_view``).

The JAX package has no kernel of its own here: ``ReducedView.emit``
(``vexcl_tpu/expr/view.py:381-384``) calls ``jnp.sum``/``min``/``max``/
``prod`` over the viewed array and XLA fuses the view into the reduce.
The port generates one Triton kernel per structural signature, from the
emitter that writes the assignment kernels:

``out[o] = (+) over r of inner(p(o, r))``, where the inner expression (a
view, usually) has shape S, o runs over the axes of S that are kept and
r over the reduced ones, and p is the row-major position in S of the
pair.  The inner expression is emitted at p by the views' machinery
(V1), so a slicer, a reshape or a permutation under the reduction reads
its leaves in place.  Where the inner is itself an affine view, the
kernel hands it the coordinates of (o, r) over its axes (the axis
pattern of kept and reduced axes is part of the key), so no lane
divides by a runtime count in the loop, and an axis read with
coefficient 1 is added unscaled: Triton sees the lanes' contiguity.

The schedule (``plan``, a function of the output and reduced counts,
whether the innermost axis is reduced, the value's width and the SM
count only, so a result repeats bit for bit on one card):

* a program's ``BLOCK`` lanes are a tile of ``OT`` outputs by ``RT``
  reduced steps, 8 warps.  Where the innermost axis of S is reduced
  (row sums), the reduced index runs fastest across the lanes: a row as
  long as a program's budget (8 KB of values) takes all of its lanes, a
  shorter one a warp's 32 lanes, several rows a program, so that each
  row's fold stays within its warp.  Where the innermost axis is kept
  (column reductions), the output does, ``OT`` up to 32 (a warp's row
  segment, 128 bytes at f32), and each lane folds ``UNROLL`` reduced
  steps among themselves before the one dependent combine with its
  accumulator, 16 KB of values in flight a program;
* the outputs give ``cdiv(n_out, OT)`` tiles (grid axis 0).  Where they
  are fewer than ``SMs x PROGRAMS_PER_SM``, the reduced range is split
  into ``nsplit`` chunks (grid axis 1): each program folds its chunk for
  its tile, stores its partials in the accumulator's type to scratch and
  draws its tile's ticket (``tl.atomic_add``, acq_rel at GPU scope); the
  program that draws the tile's last ticket reads the partials past L1
  (``volatile``), folds them in a fixed order (lane s of an output the
  splits s, s + RT, ..., then the tile's reduction), stores the results
  and sets the ticket back to 0 (the scheme of
  ``ops/triton_reduce.py``).  One ticket a tile, so no program folds the
  partials of every output.  Scratch and tickets are kept per (device,
  stream);
* at the end the tile is reshaped to (OT, RT) and reduced along the
  reduced axis.

The kernel is bound by device memory: one read of the inner's leaves and
one write of the output (a row or column reduction of 4096 x 4096 f32:
67 MB, 0.0200 ms at 3.35 TB/s).  A column reduction of that grid is 128
tiles of 32 columns, each split into 5 chunks of 896 rows: 640
programs.  The constants were chosen on an H100 by
``scripts/torch_view_turns.py`` (PERF.md §6).

Accumulation: f32 for f32 and 16-bit floats, f64 for f64, i64 (u64) for
integer and boolean sums and products; min and max in the value's type
(i32 for booleans), NaN propagated (``propagate_nan=ALL``) in the fold,
the tile's reduction and the combine of the partials, so a split
returns NaN where any chunk holds one.

``reduce_view_apply`` is the wrapper: the kernel for CUDA tensors, the
plain ``sum``/``prod``/``amin``/``amax`` over the viewed tensor for CPU
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .._build import written
from ..cache import kernel_cache
from ..config import config
from ..expr.node import Analysis, Expr
from ..expr.triton_emit import (_HEADER, _NAN_ALL, Emitter, jit_header,
                                kernel_key, launch_args, plain_value,
                                tl_type)
from ..types import COMPLEX_CODES, code_of, dtype_of_code
from .triton_reduce import _programs, min_max_plain

__all__ = ["reduce_view_apply", "reduce_view_plain", "reduce_view_source",
           "reduce_view_eval", "prepare_reduce_view", "plan", "Plan",
           "schedule", "Schedule"]

REDUCE_VIEW_WARPS = 8
#: bytes of values a program has in flight in one pass of its loop: its
#: lanes times the reduced steps each folds before its dependent combine
#: (a column reduction; a row reduction, whose loop is short, takes
#: ``ROW_STEP_BYTES``)
STEP_BYTES = 16384
ROW_STEP_BYTES = 8192
#: outputs of a column reduction's tile: a warp's row segment (128
#: bytes of f32)
MAX_OT = 32
#: lanes of a column reduction's tile (the rest of the budget unrolled)
COLUMN_BLOCK = 1024
OPS = ("sum", "prod", "min", "max")

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
def mul(a, b):
    return a * b


"""


def _acc_code(op: str, code: str, kernel: bool = True) -> str:
    """The accumulator type of ``op`` over ``code``; with ``kernel``,
    raise on complex values, which the CUDA kernel does not cover and the
    plain form reduces in their own type."""
    dt = dtype_of_code(code)
    if dt.is_complex:
        if kernel:
            raise NotImplementedError("complex reductions are not covered "
                                      "by the CUDA reduce_view kernel")
        return "c128" if code == "c*" else code
    if dt.is_floating_point:
        return "f64" if dt == torch.float64 else "f32"
    if op in ("sum", "prod"):
        return "u64" if code in ("u8", "u16", "u32", "u64") else "i64"
    return "i32" if dt == torch.bool else code


def _identity(op: str, acc: str) -> str:
    if op == "sum":
        return "0"
    if op == "prod":
        return "1"
    dt = dtype_of_code(acc)
    if dt.is_floating_point:
        return "float('inf')" if op == "min" else "float('-inf')"
    info = torch.iinfo(dt)
    return str(info.max if op == "min" else info.min)


def _layout(shape: Sequence[int], axes: Sequence[int]):
    """(kept counts, kept coefficients, reduced counts, reduced
    coefficients, whether the reduced index runs fastest (the innermost
    axis is reduced), the axis pattern: ``k`` or ``r`` an axis)."""
    strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    kept = [d for d in range(len(shape)) if d not in axes]
    red = [d for d in range(len(shape)) if d in axes]
    pattern = "".join("r" if d in axes else "k" for d in range(len(shape)))
    return ([shape[d] for d in kept], [strides[d] for d in kept],
            [shape[d] for d in red], [strides[d] for d in red],
            bool(red) and red[-1] == len(shape) - 1, pattern)


class Plan(NamedTuple):
    """A reduction's schedule (see the module's docstring)."""

    ot: int        #: outputs of a program's tile
    rt: int        #: reduced steps of a tile's lanes (ot * rt lanes)
    unroll: int    #: steps a lane folds before combining with its acc
    tiles: int     #: output tiles: grid axis 0
    nsplit: int    #: chunks of the reduced range: grid axis 1
    chunk: int     #: reduced indices a chunk, a multiple of rt * unroll


def _pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def plan(n_out: int, nred: int, r_fast: bool, itemsize: int,
         programs: int) -> Plan:
    """The schedule of a reduction of ``nred`` steps into ``n_out``
    outputs of values ``itemsize`` bytes wide, on a card whose grid
    should hold ``programs`` programs to be full."""
    # values a program has in flight in one pass of its loop
    budget = (ROW_STEP_BYTES if r_fast else STEP_BYTES) // max(4, itemsize)
    if r_fast:
        # a row as long as the budget takes a program's lanes; a shorter
        # one a warp's 32, several rows a program, so that each row's fold
        # stays within its warp
        rt = min(budget, _pow2(nred)) if nred >= budget else min(
            32, _pow2(nred))
        ot, unroll = budget // rt, 1
    else:
        ot = min(MAX_OT, _pow2(n_out))
        rt = max(1, min(budget, COLUMN_BLOCK) // ot)
        unroll = max(1, min(budget // (ot * rt), _pow2(-(-nred // rt))))
    step = rt * unroll
    tiles = -(-n_out // ot)
    nsplit = max(1, min(-(-programs // tiles), -(-nred // step)))
    chunk = max(step, -(-(-(-nred // nsplit)) // step) * step)
    nsplit = max(1, -(-nred // chunk))
    return Plan(ot, rt, unroll, tiles, nsplit, chunk)


class Schedule(NamedTuple):
    """What a launch needs of (shape, axes, itemsize, programs) alone."""

    pattern: str   #: ``k`` or ``r`` an axis (``_layout``)
    n_out: int     #: outputs
    plan: Plan
    #: the kernel's integer arguments: n_out, nred, chunk, nsplit, the
    #: kept counts (but the first) and coefficients, the reduced ones
    ints: Tuple[int, ...]


#: (shape, axes, itemsize, programs) -> Schedule
_schedules: Dict[tuple, Schedule] = {}


def schedule(shape: Tuple[int, ...], axes: Tuple[int, ...], itemsize: int,
             programs: int) -> Schedule:
    """The layout and ``plan`` of a reduction of ``shape`` over ``axes``
    of values ``itemsize`` bytes wide on a card of ``programs`` programs,
    computed once (Python ints) and kept."""
    key = (shape, axes, itemsize, programs)
    hit = _schedules.get(key)
    if hit is None:
        kcount, kcoef, rcount, rcoef, r_fast, pattern = _layout(shape, axes)
        n_out, nred = math.prod(kcount), math.prod(rcount)
        pl = plan(n_out, nred, r_fast, itemsize, programs)
        hit = Schedule(pattern, n_out, pl, (
            n_out, nred, pl.chunk, pl.nsplit, *kcount[1:], *kcoef,
            *rcount[1:], *rcoef))
        _schedules[key] = hit
    return hit


def _fold(vals: List[str], fn) -> str:
    """Pairwise fold of ``vals`` by ``fn`` (text): a fixed order."""
    while len(vals) > 1:
        vals = [fn(vals[i], vals[i + 1]) if i + 1 < len(vals) else vals[i]
                for i in range(0, len(vals), 2)]
    return vals[0]


def reduce_view_source(inner: Expr, analysis: Analysis,
                       types: Dict[int, str], op: str, pattern: str,
                       unroll: int, out_code: str) -> str:
    """The kernel reducing ``inner`` (its axes kept or reduced as
    ``pattern`` says) into ``out_ptr``, in type ``out_code``, folding
    ``unroll`` reduced steps a lane at a time."""
    from ..expr.view import _AffineView

    r_fast = pattern.endswith("r")
    em = Emitter(analysis, types)
    ity = em.ity
    acc = _acc_code(op, types[id(inner)])
    if any(c in COMPLEX_CODES for c in types.values()):
        raise NotImplementedError("complex values are not covered by the "
                                  "CUDA reduce_view kernel")
    tl_acc, idv = tl_type(acc), _identity(op, acc)
    nk, nr = pattern.count("k"), pattern.count("r")
    kc = [f"kc{e}" for e in range(1, nk)]
    kk = [f"kk{e}" for e in range(nk)]
    rc = [f"rc{e}" for e in range(1, nr)]
    rk = [f"rk{e}" for e in range(nr)]
    ints = ["n_out", "nred", "chunk", "nsplit", *kc, *kk, *rc, *rk]
    iv = {a: em.define(f"{a}.to({ity})") for a in ints}
    lane = em.define(f"tl.arange(0, BLOCK).to({ity})")
    if r_fast:
        ol, rl = em.define(f"{lane} // RT"), em.define(f"{lane} % RT")
    else:
        ol, rl = em.define(f"{lane} % OT"), em.define(f"{lane} // OT")
    pid = em.define(f"tl.program_id(0).to({ity})")
    o = em.define(f"{pid} * OT + {ol}")
    mo = em.define(f"{o} < {iv['n_out']}")
    kept = (em.unravel(o, [None] + [iv[a] for a in kc]) if nk > 1
            else [o] * nk)
    po = em.define(f"tl.zeros([BLOCK], {ity})")
    for c, k in zip(kept, kk):
        po = em.define(f"{po} + {c} * {iv[k]}")
    rbeg = em.define(f"tl.program_id(1).to({ity}) * {iv['chunk']}")
    rend = em.define(f"tl.minimum({rbeg} + {iv['chunk']}, {iv['nred']})")
    pre, em.lines = em.lines, []
    is_float = dtype_of_code(acc).is_floating_point
    if op == "sum":
        comb, red = "({} + {})", "tl.sum(tile, axis={ax})"
    elif op == "prod":
        comb, red = "({} * {})", "tl.reduce(tile, {ax}, mul)"
    else:
        fn = op + ("_nan" if is_float else "_int")
        comb, red = fn + "({}, {})", "tl.reduce(tile, {ax}, " + fn + ")"
    vals = []
    for u in range(unroll):
        rv = em.define(f"rstart + {u} * RT + {rl}")
        m = em.define(f"{mo} & ({rv} < {rend})")
        red_c = (em.unravel(rv, [None] + [iv[a] for a in rc]) if nr > 1
                 else [rv] * nr)
        p = po
        for c, k in zip(red_c, rk):
            p = em.define(f"{p} + {c} * {iv[k]}")
        if isinstance(inner, _AffineView) and len(inner.axes) == len(
                pattern):
            ki, ri = iter(kept), iter(red_c)
            em.coords[(id(inner), p)] = [next(ri) if a == "r" else next(ki)
                                         for a in pattern]
        v = em.cast(em.value(inner, (p, m)), types[id(inner)], acc)
        vals.append(em.define(f"tl.where({m}, {v}, {idv})"))
    loop, em.lines = em.lines, []
    res = em.cast("res", acc, out_code)
    shape, ax = ("(OT, RT)", 1) if r_fast else ("(RT, OT)", 0)
    src = [_HEADER, _COMBINES,
           jit_header("reduce_view_kernel", analysis,
                      ["out_ptr", "part_ptr", "ticket_ptr"],
                      ints + ["OT: tl.constexpr", "RT: tl.constexpr",
                              "BLOCK: tl.constexpr", "SPLIT: tl.constexpr"],
                      ints)]
    src += [f"    {line}\n" for line in pre]
    src += [f"    acc = tl.full([BLOCK], {idv}, {tl_acc})\n",
            f"    for rstart in range({rbeg}, {rend}, RT * {unroll}):\n"]
    src += [f"        {line}\n" for line in loop]
    src += [f"        acc = {comb.format('acc', _fold(vals, comb.format))}\n",
            f"    tile = tl.reshape(acc, {shape})\n",
            f"    res = {red.format(ax=ax)}\n",
            f"    oo = {pid} * OT + tl.arange(0, OT).to({ity})\n",
            "    if SPLIT:\n",
            f"        part = part_ptr.to(tl.pointer_type({tl_acc}))\n",
            f"        tl.store(part + tl.program_id(1).to({ity}) * "
            f"{iv['n_out']} + oo, res, mask=oo < {iv['n_out']})\n",
            "        tl.debug_barrier()\n",
            "        ticket = tl.atomic_add(ticket_ptr + tl.program_id(0), 1, "
            "sem='acq_rel', scope='gpu')\n",
            f"        if ticket == {iv['nsplit']} - 1:\n",
            # the last program of the tile folds the nsplit partials of
            # its outputs: lane (o, s) the splits s, s + RT, ...
            f"            acc = tl.full([BLOCK], {idv}, {tl_acc})\n",
            f"            for s0 in range(0, {iv['nsplit']}, RT):\n",
            f"                sv = s0 + {rl}\n",
            f"                ms = {mo} & (sv < {iv['nsplit']})\n",
            f"                v = tl.load(part + sv * {iv['n_out']} + {o}, "
            "mask=ms, volatile=True)\n",
            f"                acc = {comb.format('acc', f'tl.where(ms, v, {idv})')}"
            "\n",
            f"            tile = tl.reshape(acc, {shape})\n",
            f"            res = {red.format(ax=ax)}\n",
            f"            tl.store(out_ptr + oo, {res}, "
            f"mask=oo < {iv['n_out']})\n",
            "            tl.store(ticket_ptr + tl.program_id(0), 0)\n",
            "    else:\n",
            f"        tl.store(out_ptr + oo, {res}, mask=oo < {iv['n_out']})\n"]
    return "".join(src)


#: (device index, stream) -> (partials as int64 words, zeroed int32
#: tickets)
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
#: entries kept; past it the oldest is freed (see ``cuda_scratch``)
_MAX_ENTRIES = 64


def _scratch_for(device: torch.device, words: int, tiles: int):
    """At least ``words`` partial words and ``tiles`` zeroed tickets of
    the current stream on ``device``; grown (doubled) when a call needs
    more.  Every launch leaves its tickets at 0."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    s = _scratch.get(key)
    if s is None or s[0].numel() < words or s[1].numel() < tiles:
        old = (0, 0) if s is None else (s[0].numel(), s[1].numel())
        s = (torch.empty(max(words, 2 * old[0]), dtype=torch.int64,
                         device=device),
             torch.zeros(max(tiles, 2 * old[1]), dtype=torch.int32,
                         device=device))
        _scratch[key] = s
        while len(_scratch) > _MAX_ENTRIES:
            del _scratch[next(iter(_scratch))]
    return s


class _ReduceViewKernel:
    """The kernel cache's entry: the launcher (``_build.TritonLauncher``);
    a call's schedule comes from ``schedule``."""

    def __init__(self, src: str):
        from .._build import TritonLauncher, triton_module

        if config.show_kernels:
            print(src)
        self.launcher = TritonLauncher(triton_module(src).reduce_view_kernel,
                                       REDUCE_VIEW_WARPS)

    def launch(self, out: torch.Tensor, leaves: Sequence,
               sch: Schedule) -> None:
        pl = sch.plan
        split = pl.nsplit > 1
        if split:
            part, ticket = _scratch_for(out.device, pl.nsplit * sch.n_out,
                                        pl.tiles)
        else:
            part = ticket = out    # not read: SPLIT is False
        self.launcher((pl.tiles, pl.nsplit),
                      [out, part, ticket, *launch_args(leaves)], sch.ints,
                      (pl.ot, pl.rt, pl.ot * pl.rt, split), out.device)
        written(out)


def reduce_view_plain(inner: Expr, analysis: Analysis, types, leaves, op: str,
                      shape: Sequence[int], axes: Sequence[int],
                      out: torch.Tensor) -> None:
    """The kernel's plain PyTorch version: the reduction over the viewed
    tensor, accumulated as the kernel accumulates."""
    m = int(np.prod(shape, dtype=np.int64))
    v = plain_value(inner, analysis, types, leaves, m, out.device)
    acc = dtype_of_code(_acc_code(op, types[id(inner)], kernel=False))
    v = v.to(acc).reshape(tuple(shape))
    if not axes:
        res = v
    elif op == "sum":
        res = torch.sum(v, dim=tuple(axes))
    elif op == "prod":
        res = v
        for a in sorted(axes, reverse=True):
            res = torch.prod(res, dim=a)
    else:
        res = min_max_plain(v, op == "min", tuple(axes))
    out.copy_(res.reshape(-1))


def reduce_view_apply(inner: Expr, analysis: Analysis, types, leaves,
                      op: str, shape: Sequence[int], axes: Sequence[int],
                      out: torch.Tensor) -> None:
    """Reduce the (prepared) ``inner`` of ``shape`` over ``axes`` by
    ``op`` into ``out`` (1-D, the kept axes' elements)."""
    if op not in OPS:
        raise ValueError(f"unknown reduction {op!r}")
    if out.device.type == "cpu":
        reduce_view_plain(inner, analysis, types, leaves, op, shape, axes,
                          out)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no reduce_view kernel for {out.device}")
    code = types[id(inner)]
    sch = schedule(tuple(shape), tuple(axes), dtype_of_code(code).itemsize,
                   _programs(out.device))
    if sch.n_out == 0:
        return
    pl = sch.plan
    key = ("reduce_view", op, sch.pattern, pl.ot, pl.rt,
           pl.unroll) + kernel_key(analysis, (out.dtype,))

    def factory():
        return _ReduceViewKernel(reduce_view_source(
            inner, analysis, types, op, sch.pattern, pl.unroll,
            code_of(out.dtype)))

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    k.launch(out, leaves, sch)
    reduce_view_apply.launches += 1


#: launches of the reduce_view kernel (V2; not of its plain version)
reduce_view_apply.launches = 0


def prepare_reduce_view(node, device: torch.device, stages=None):
    """The arguments of the V2 kernel for a ``ReducedView``: (inner,
    analysis, types, leaves, op, shape, axes, a new output tensor), the
    inner expression hoisted (``compile.hoist``'s ``stages``), analysed
    and checked over its length."""
    from ..expr.compile import fit_index_bits, prepare_multi

    m = int(np.prod(node.shape, dtype=np.int64))
    (inner,), analysis, types, leaves = prepare_multi([node.children[0]], m,
                                                      device, stages)
    fit_index_bits(analysis, m)
    code = node._infer([types[id(inner)]])
    out = torch.empty(node.size_hint(), dtype=dtype_of_code(code),
                      device=device)
    return inner, analysis, types, leaves, node.op, node.shape, node.axes, out


def reduce_view_eval(node, device: torch.device,
                     stages=None) -> torch.Tensor:
    """A ``ReducedView`` into a new tensor on ``device``: one V2 launch
    (the plain version on the CPU, or where ``stages`` ask for it)."""
    args = prepare_reduce_view(node, device, stages)
    plain = stages is not None and stages.plain
    (reduce_view_plain if plain else reduce_view_apply)(*args)
    return args[-1]
