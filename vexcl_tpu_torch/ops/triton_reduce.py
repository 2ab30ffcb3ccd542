"""The map-reduce kernel (Triton): SUM, MIN or MAX of an expression.

Replaces ``vexcl_tpu/ops/pallas_reduce.py::_kernel`` (called through
``pallas_map_reduce``).  On the TPU the grid runs in order on one core, so
that kernel carries one running total in SMEM from block to block.  CUDA
blocks run at the same time and in no order, so here the reduction has
two passes, deterministic and without atomics:

1. one program per ``BLOCK`` elements evaluates the expression body that
   ``expr/triton_emit.py`` generates for the assignment kernel, replaces
   the tail lanes by the identity AFTER the map (as ``pallas_reduce.py``
   does: ``sum(exp(x))`` must not count ``exp(0)`` for padded lanes), and
   writes one partial to a ``torch.empty`` buffer;
2. one program combines the partials in a fixed order.

Accumulation is in f32 for f32 (and 16-bit) values, as ``acc_dtype`` in
the JAX kernel, in f64 for f64 and in i64 for integer SUM.  The kernel
serves every size: the TPU's ``n >= 2*BLOCK`` threshold was a TPU choice.
Pass 1 is bound by device memory bandwidth (one read of each leaf); pass
2 reads ``n / BLOCK`` partials.  MIN and MAX propagate NaN, as ``jnp.min``
and ``jnp.max`` do: both passes combine floats with ``tl.minimum`` /
``tl.maximum`` under ``propagate_nan=ALL`` (``tl.min`` and ``tl.max``
drop NaN).  Tail lanes still hold the identity, +-inf.

``map_reduce`` is the wrapper: the kernel for CUDA tensors, the plain
PyTorch reduction of the tree's ``emit`` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..cache import kernel_cache
from ..config import config
from ..expr.node import Analysis, Expr
from ..expr.triton_emit import (_HEADER, _NAN_ALL, body, jit_header,
                                kernel_key, launch_args, plain_value, tl_type)
from ..types import dtype_of_code

__all__ = ["map_reduce", "map_reduce_plain", "reduce_source", "acc_code",
           "REDUCE_BLOCK"]

REDUCE_BLOCK = 4096
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
    ident = f"tl.full([BLOCK], {_identity(kind, acc)}, {tl_type(acc)})"
    src = [_HEADER]
    if kind == "SUM":
        red, comb = "tl.sum({}, axis=0)", "acc + v"
    else:
        fn = "minimum" if kind == "MIN" else "maximum"
        nan = f", {_NAN_ALL}" if dtype_of_code(acc).is_floating_point else ""
        src.append(f"@triton.jit\ndef combine(a, b):\n"
                   f"    return tl.{fn}(a, b{nan})\n\n\n")
        red, comb = "tl.reduce({}, 0, combine)", "combine(acc, v)"
    src += [jit_header("partial_kernel", analysis, ["part_ptr"],
                       ["n", "BLOCK: tl.constexpr"]),
            "    pid = tl.program_id(0)\n",
            "    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)\n",
            "    mask = offs < n\n"]
    src += [f"    {line}\n" for line in lines]
    src += [f"    v = tl.where(mask, {res}, {ident})\n",
            f"    tl.store(part_ptr + pid, {red.format('v')})\n\n\n",
            "@triton.jit\n",
            "def final_kernel(part_ptr, out_ptr, m, BLOCK: tl.constexpr):\n",
            f"    acc = {ident}\n",
            "    for start in range(0, m, BLOCK):\n",
            "        o = start + tl.arange(0, BLOCK)\n",
            f"        v = tl.load(part_ptr + o, mask=o < m, other={ident})\n",
            f"        acc = {comb}\n",
            f"    tl.store(out_ptr, {red.format('acc')})\n"]
    return "".join(src)


class _ReduceKernel:
    def __init__(self, src: str, acc: str):
        from .._build import triton_module

        if config.show_kernels:
            print(src)
        self.acc = dtype_of_code(acc)
        mod = triton_module(src)
        self.partial, self.final = mod.partial_kernel, mod.final_kernel

    def launch(self, leaves: Sequence, n: int, device) -> torch.Tensor:
        import triton

        m = triton.cdiv(n, REDUCE_BLOCK)
        part = torch.empty(m, dtype=self.acc, device=device)
        out = torch.empty(1, dtype=self.acc, device=device)
        with torch.cuda.device(device):
            self.partial[(m,)](part, *launch_args(leaves), n,
                               BLOCK=REDUCE_BLOCK, num_warps=8)
            self.final[(1,)](part, out, m, BLOCK=FINAL_BLOCK, num_warps=4)
        return out[0]


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
