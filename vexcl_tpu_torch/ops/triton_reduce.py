"""The map-reduce kernel (Triton): SUM, MIN or MAX of an expression.

Replaces ``vexcl_tpu/ops/pallas_reduce.py::_kernel`` (called through
``pallas_map_reduce``).  On the TPU the grid runs in order on one core, so
that kernel carries one running total in SMEM from block to block.  CUDA
blocks run at the same time and in no order; here one persistent launch
does the whole reduction, deterministic and without atomics on the data:

1. the grid is ``min(cdiv(n, BLOCK), SMs x PROGRAMS_PER_SM)`` programs.
   Program p walks tiles p, p + grid, p + 2 grid, ... (``tl.range``,
   ``num_stages=REDUCE_STAGES``), evaluates the expression body that
   ``expr/triton_emit.py`` generates for the assignment kernel, replaces
   the tail lanes by the identity AFTER the map (as ``pallas_reduce.py``
   does: ``sum(exp(x))`` must not count ``exp(0)`` for padded lanes), and
   folds the tile into a ``BLOCK``-wide accumulator in registers, which it
   reduces once at the end and stores as its partial;
2. each program then draws a ticket (``tl.atomic_add``, acq_rel at GPU
   scope); the one that draws the last ticket reads every partial past L1
   (``volatile``), combines them in program order, writes the result and
   sets the ticket back to 0.

Tiles belong to programs in a fixed way and the partials combine in a
fixed order, so a result is the same bits from call to call on one card.
The partials and the ticket are scratch allocated once per (device,
stream, accumulator type): keyed by stream, two reductions enqueued on two
streams never share a ticket.  Only the 0-d result is allocated per
call.

Accumulation is in f32 for f32 (and 16-bit) values, as ``acc_dtype`` in
the JAX kernel, in f64 for f64 and in i64 (u64) for integer SUM.  The
kernel serves every size: the TPU's ``n >= 2*BLOCK`` threshold was a TPU
choice.  It is bound by device memory bandwidth: one read of each leaf,
e.g. 134 MB for ``Sum(p*Ap)`` at 2^24 f32, 0.0401 ms at 3.35 TB/s.  The
two-pass form it replaces ran 4096 one-tile programs (31 waves over 132
SMs), each ending in a block-wide reduction with no loads in flight, and
made two launches and two allocations per call.  MIN and MAX propagate
NaN, as ``jnp.min`` and ``jnp.max`` do: both the per-program and the
final combine use ``tl.minimum`` / ``tl.maximum`` under
``propagate_nan=ALL`` (``tl.min`` and ``tl.max`` drop NaN).  Tail lanes
still hold the identity, +-inf.

``map_reduce`` is the wrapper: the kernel for CUDA tensors, the plain
PyTorch reduction of the tree's ``emit`` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..cache import kernel_cache
from ..config import config
from ..expr.node import Analysis, Expr
from ..expr.triton_emit import (_HEADER, _NAN_ALL, body, jit_header,
                                kernel_key, launch_args, plain_value, tl_type)
from ..types import dtype_of_code

__all__ = ["map_reduce", "map_reduce_plain", "reduce_source", "acc_code",
           "REDUCE_BLOCK"]

#: elements per tile (per program per grid-stride step)
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

KINDS = ("SUM", "MIN", "MAX")


def acc_code(kind: str, code: str) -> str:
    """Accumulator type of a reduction over values of type ``code``."""
    dt = dtype_of_code(code)
    if dt.is_complex:
        raise NotImplementedError("complex reductions are not covered by "
                                  "the CUDA map-reduce kernel")
    if dt.is_floating_point:
        return "f64" if dt == torch.float64 else "f32"
    if kind == "SUM":
        return "u64" if dt == torch.uint64 else "i64"
    if dt == torch.bool:
        raise NotImplementedError("MIN/MAX of booleans is not covered by the "
                                  "CUDA map-reduce kernel")
    return code


def _identity(kind: str, code: str) -> str:
    if kind == "SUM":
        return "0"
    dt = dtype_of_code(code)
    if dt.is_floating_point:
        return "float('inf')" if kind == "MIN" else "float('-inf')"
    info = torch.iinfo(dt)
    return str(info.max if kind == "MIN" else info.min)


def reduce_source(expr: Expr, analysis: Analysis, types: Dict[int, str],
                  kind: str) -> str:
    acc = acc_code(kind, types[id(expr)])
    lines, res = body(expr, analysis, types, acc)
    idv = _identity(kind, acc)

    def ident(width):
        return f"tl.full([{width}], {idv}, {tl_type(acc)})"
    src = [_HEADER]
    if kind == "SUM":
        red, comb = "tl.sum({}, axis=0)", "{} + {}"
    else:
        fn = "minimum" if kind == "MIN" else "maximum"
        nan = f", {_NAN_ALL}" if dtype_of_code(acc).is_floating_point else ""
        src.append(f"@triton.jit\ndef combine(a, b):\n"
                   f"    return tl.{fn}(a, b{nan})\n\n\n")
        red, comb = "tl.reduce({}, 0, combine)", "combine({}, {})"
    value = f"tl.where(mask, {res}, {ident('BLOCK')})"
    src += [jit_header("reduce_kernel", analysis,
                       ["part_ptr", "ticket_ptr", "out_ptr"],
                       ["n", "ntiles", "BLOCK: tl.constexpr",
                        "FINAL: tl.constexpr"]),
            "    pid = tl.program_id(0)\n",
            "    nprog = tl.num_programs(0)\n",
            f"    acc = {ident('BLOCK')}\n",
            "    for tile in tl.range(pid, ntiles, nprog, "
            f"num_stages={REDUCE_STAGES}):\n",
            "        offs = tile.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)\n",
            "        mask = offs < n\n"]
    src += [f"        {line}\n" for line in lines]
    src += [f"        acc = {comb.format('acc', value)}\n",
            f"    tl.store(part_ptr + pid, {red.format('acc')})\n",
            "    tl.debug_barrier()\n",
            "    ticket = tl.atomic_add(ticket_ptr, 1, sem='acq_rel', "
            "scope='gpu')\n",
            "    if ticket == nprog - 1:\n",
            f"        tot = {ident('FINAL')}\n",
            "        for start in range(0, nprog, FINAL):\n",
            "            o = start + tl.arange(0, FINAL)\n",
            f"            v = tl.load(part_ptr + o, mask=o < nprog, other={idv}, "
            "volatile=True)\n",
            f"            tot = {comb.format('tot', 'v')}\n",
            f"        tl.store(out_ptr, {red.format('tot')})\n",
            "        tl.store(ticket_ptr, 0)\n"]
    return "".join(src)


#: (device, stream, accumulator dtype) -> (partials, ticket)
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
#: entries kept; past it the oldest is freed (see ``cuda_compact``)
_MAX_ENTRIES = 64
_sm_count: Dict[torch.device, int] = {}


def _programs(device: torch.device) -> int:
    """The persistent grid's ceiling on ``device``."""
    sms = _sm_count.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device] = sms
    return sms * PROGRAMS_PER_SM


def _scratch_for(device: torch.device, dtype: torch.dtype):
    """The partials (one per program of the largest grid) and the zeroed
    ticket of the current stream on ``device`` (an indexed CUDA device),
    allocated at first use."""
    # the raw stream handle, as Triton's launcher reads it: ~0.1 us where
    # torch.cuda.current_stream() builds a Stream object (~3 us a call)
    key = (device, torch._C._cuda_getCurrentRawStream(device.index), dtype)
    s = _scratch.get(key)
    if s is None:
        s = (torch.empty(_programs(device), dtype=dtype, device=device),
             torch.zeros(1, dtype=torch.int32, device=device))
        _scratch[key] = s
        while len(_scratch) > _MAX_ENTRIES:
            del _scratch[next(iter(_scratch))]
    return s


class _ReduceKernel:
    def __init__(self, src: str, acc: str):
        from .._build import triton_module

        if config.show_kernels:
            print(src)
        self.acc = dtype_of_code(acc)
        self.fn = triton_module(src).reduce_kernel

    def launch(self, leaves: Sequence, n: int, device) -> torch.Tensor:
        ntiles = -(-n // REDUCE_BLOCK)
        nprog = min(ntiles, _programs(device))
        part, ticket = _scratch_for(device, self.acc)
        out = torch.empty((), dtype=self.acc, device=device)
        args = (part, ticket, out, *launch_args(leaves), n, ntiles)
        opts = dict(BLOCK=REDUCE_BLOCK, FINAL=FINAL_BLOCK,
                    num_warps=REDUCE_WARPS)
        # Triton launches on the current device: switch only when needed
        # (entering torch.cuda.device costs a few us of a ~40 us call)
        if torch.cuda.current_device() == device.index:
            self.fn[(nprog,)](*args, **opts)
        else:
            with torch.cuda.device(device):
                self.fn[(nprog,)](*args, **opts)
        return out


def map_reduce_plain(expr: Expr, analysis: Analysis, types, leaves, n: int,
                     kind: str, device) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    val = plain_value(expr, analysis, types, leaves, n, device)
    if kind == "SUM":
        dt = dtype_of_code(acc_code(kind, types[id(expr)]))
        return torch.sum(val.to(dt))
    return torch.amin(val) if kind == "MIN" else torch.amax(val)


def map_reduce(expr: Expr, analysis: Analysis, types, leaves, n: int,
               kind: str, device: torch.device) -> torch.Tensor:
    """Reduce the elementwise ``expr`` over ``n`` elements to a 0-d
    tensor on ``device``."""
    if kind not in KINDS:
        raise ValueError(f"unknown reduction kind {kind!r}")
    if device.type == "cpu":
        return map_reduce_plain(expr, analysis, types, leaves, n, kind,
                                device)
    if device.type != "cuda":
        raise NotImplementedError(f"no map-reduce kernel for {device}")
    if n == 0:
        raise ValueError("reduction over an empty expression")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    acc = acc_code(kind, types[id(expr)])
    key = ("reduce", kind) + kernel_key(analysis, None)

    def factory():
        return _ReduceKernel(reduce_source(expr, analysis, types, kind), acc)

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    res = k.launch(leaves, n, device)
    map_reduce.launches += 1
    return res


#: launches of the map-reduce kernel (not of its plain version)
map_reduce.launches = 0
