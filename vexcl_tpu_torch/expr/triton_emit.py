"""The expression emitter: generated Triton kernels per signature.

The JAX package has no kernel of its own here: ``expr/compile.py`` traces
the tree into a jitted function and XLA fuses it into one kernel.  The
port has no XLA, so this module does what VexCL's CUDA backend does
(vexcl/operations.hpp ``vector_expr_context`` :1196-1353): it walks one
analysed expression and writes kernel source.  From the same body it
produces

* the assignment kernel (``assign_multi_source``): one program per
  ``BLOCK`` elements with a masked tail; each leaf is loaded once, every
  node of the union of the k trees is evaluated once in registers (the
  emitter memoizes by node, so a DAG such as an RK4 step stays the size
  of its nodes), and each of the k results is cast to its target's type
  and stored in place.  Every load comes before the first store, so
  targets that are also leaves read their old values:
  ``tie(x, y) = (y, x)`` swaps and an in-place Lorenz step reads the old
  state.  ``x[:] = e`` is its k = 1 case (``assign``); ``tie``,
  ``multivector`` and the symbolic generator's kernels are the rest
  (``assign_multi``, XLA's fusion of ``vexcl_tpu/expr/compile.py``'s
  ``evaluate_multi`` on the TPU);
* the map-reduce bodies used by ``ops/triton_reduce.py``.

Every node is cast to the type the port inferred for it (``types.py``
follows the JAX package's promotion, not Triton's), scalar leaves are
passed in their own type (a Python float is passed as its 64 bits, since
Triton would pass it as f32), and integer ``//`` and ``%`` are corrected
to floor semantics (Triton's are C's).  A node or builtin outside this
coverage raises ``NotImplementedError`` on CUDA.

The kernel is bound by device memory bandwidth: it reads each leaf once
and writes each destination once, one 16-byte access per thread per leaf
at f32 with ``BLOCK`` 1024 and 4 warps (the Lorenz RK4 step at 2^22 f32:
117 MB, 0.0350 ms at 3.35 TB/s, against ~75 flops an element).
``assign`` and ``assign_multi`` are the wrappers: they launch the kernel
for CUDA tensors and run the trees' plain PyTorch forms (``Expr.emit``)
for CPU tensors.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import torch

from ..cache import kernel_cache
from ..config import config
from ..types import code_of, dtype_of_code, scalar_code
from .node import Analysis, EmitEnv, Expr

__all__ = ["Emitter", "assign_source", "assign_multi_source", "assign",
           "assign_plain", "assign_multi", "assign_multi_plain",
           "plain_value", "plain_values", "kernel_key", "launch_args",
           "ASSIGN_BLOCK"]

ASSIGN_BLOCK = 1024

_TL = {
    "b1": "tl.int1", "u8": "tl.uint8", "u16": "tl.uint16",
    "u32": "tl.uint32", "u64": "tl.uint64", "i8": "tl.int8",
    "i16": "tl.int16", "i32": "tl.int32", "i64": "tl.int64",
    "bf16": "tl.bfloat16", "f16": "tl.float16", "f32": "tl.float32",
    "f64": "tl.float64", "i*": "tl.int64", "f*": "tl.float64",
}

_HEADER = ("import triton\nimport triton.language as tl\n"
           "from triton.language.extra import libdevice\n\n\n")

_NAN_ALL = "propagate_nan=tl.PropagateNan.ALL"


def tl_type(code: str) -> str:
    try:
        return _TL[code]
    except KeyError:
        raise NotImplementedError(
            f"type {dtype_of_code(code)} is not covered by the CUDA "
            "expression kernel") from None


def _is_float(code: str) -> bool:
    return dtype_of_code(code).is_floating_point


def _is_signed(code: str) -> bool:
    return dtype_of_code(code).is_signed


def _scalar_kind(value) -> str:
    """How a scalar leaf crosses into the kernel: f64 values as their 64
    bits (``bits``), other floats as f32 (``float``), the rest as ints."""
    code = scalar_code(value)
    if code in ("f*", "f64"):
        return "bits"
    if code in ("f32", "f16", "bf16"):
        return "float"
    if code in ("c*", "c64", "c128"):
        raise NotImplementedError("complex scalars are not covered by the "
                                  "CUDA expression kernel")
    return "int"


def launch_args(leaves: Sequence) -> List:
    """Kernel arguments for the leaves, in slot order."""
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        kind = _scalar_kind(leaf)
        if kind == "bits":
            out.append(struct.unpack("<q", struct.pack("<d", float(leaf)))[0])
        elif kind == "float":
            out.append(float(leaf))
        else:
            out.append(int(leaf))
    return out


def kernel_key(analysis: Analysis, out_dtypes) -> tuple:
    """Cache key: the signature carries no leaf types (the JAX package
    leaves dtype to jit's retrace), so the key adds them, and the output
    types.  A compound op is part of the signature: its old value is a
    leaf of the tree."""
    leaf_codes = tuple(code_of(l.dtype) if isinstance(l, torch.Tensor)
                       else scalar_code(l) for l in analysis.leaves)
    return (analysis.sig, leaf_codes, out_dtypes)


class Emitter:
    """Accumulates the straight-line body of one kernel."""

    def __init__(self, analysis: Analysis, types: Dict[int, str]):
        self.analysis = analysis
        self.types = types
        self.lines: List[str] = []
        self.temps: Dict = {}
        self._vals: Dict[int, str] = {}
        self._slots: Dict[int, str] = {}
        self._n = 0

    # -- variables ------------------------------------------------------
    def value(self, node: Expr) -> str:
        vid = id(node)
        if vid not in self._vals:
            self._vals[vid] = node.emit_src(self)
        return self._vals[vid]

    def define(self, src: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"{name} = {src}")
        return name

    def cast(self, var: str, frm: str, to: str) -> str:
        if dtype_of_code(frm) == dtype_of_code(to):
            return var
        if to == "b1":
            return f"({var} != 0)"
        return f"{var}.to({tl_type(to)})"

    # -- leaves -----------------------------------------------------------
    def load(self, node: Expr) -> str:
        slot = self.analysis.slot_of[id(node)]
        if slot not in self._slots:
            tl_type(self.types[id(node)])  # raises on uncovered types
            var = f"x{slot}"
            self.lines.append(f"{var} = tl.load(p{slot} + offs, mask=mask)")
            self._slots[slot] = var
        return self._slots[slot]

    def scalar(self, node: Expr) -> str:
        slot = self.analysis.slot_of[id(node)]
        if slot not in self._slots:
            value = self.analysis.leaves[slot]
            code = self.types[id(node)]
            kind = _scalar_kind(value)
            var = f"v{slot}"
            if kind == "bits":
                src = f"s{slot}.to(tl.int64).to(tl.float64, bitcast=True)"
            else:
                src = f"s{slot}.to({tl_type(code)})"
            self.lines.append(f"{var} = {src}")
            self._slots[slot] = var
        return self._slots[slot]

    def constant(self, value, code: str) -> str:
        if isinstance(value, bool):
            lit = "1" if value else "0"
        elif isinstance(value, int) and code == "u32":
            # typed as u32 whatever its size: a bare literal of 2^31 or
            # more would be i64 in Triton, and u32 words must wrap
            lit = hex(value & 0xFFFFFFFF)
        elif isinstance(value, int):
            lit = str(int(value))
        elif isinstance(value, float):
            lit = repr(value) if value == value and abs(value) != float(
                "inf") else f"float('{value}')"
        else:
            raise NotImplementedError(
                f"constant {value!r} is not covered by the CUDA expression "
                "kernel")
        return self.define(f"tl.full([BLOCK], {lit}, {tl_type(code)})")

    def u32(self, value: int) -> str:
        """A u32 constant, defined once per kernel (the generators'
        multipliers, key increments and shift counts)."""
        key = ("u32", value & 0xFFFFFFFF)
        if key not in self.temps:
            self.temps[key] = self.constant(value, "u32")
        return self.temps[key]

    # -- operators --------------------------------------------------------
    def apply(self, form: str, args: List[str], cc: str, op: str) -> str:
        """Expression text of ``form`` over ``args`` in compute type cc."""
        if cc == "b1" and op in _ARITH:
            raise NotImplementedError(
                f"{op!r} on booleans is not covered by the CUDA expression "
                "kernel")
        named = _NAMED.get(form)
        half = cc in ("bf16", "f16")
        if half and (named is not None or "libdevice." in form):
            # libdevice has no 16-bit forms: compute in f32, round back
            args = [f"{a}.to(tl.float32)" for a in args]
            inner = named(self, args, "f32") if named else form.format(*args)
            return f"({inner}).to({tl_type(cc)})"
        if named is not None:
            return named(self, args, cc)
        if "libdevice." in form and not _is_float(cc):
            raise NotImplementedError(
                f"{op!r} on {dtype_of_code(cc)} is not covered by the CUDA "
                "expression kernel")
        return form.format(*args)


_ARITH = ("add", "sub", "mul", "div", "floordiv", "mod", "pow", "neg")


def _floordiv(em: Emitter, args, cc) -> str:
    a, b = args
    if _is_float(cc):
        # jnp's _float_divmod: fmod-based, quotient rounded half away
        m = em.define(f"libdevice.fmod({a}, {b})")
        d = em.define(f"libdevice.div_rn({a} - {m}, {b})")
        d = em.define(f"tl.where(({m} != 0) & (({b} < 0) != ({m} < 0)), "
                      f"{d} - 1, {d})")
        return f"libdevice.round({d})"
    if not _is_signed(cc):
        return f"({a} // {b})"
    q = em.define(f"({a} // {b})")  # Triton: truncating, as in C
    return (f"tl.where((({a} % {b}) != 0) & (({a} < 0) != ({b} < 0)), "
            f"{q} - 1, {q})")


def _mod(em: Emitter, args, cc) -> str:
    a, b = args
    if _is_float(cc):
        r = em.define(f"libdevice.fmod({a}, {b})")
    elif not _is_signed(cc):
        return f"({a} % {b})"
    else:
        r = em.define(f"({a} % {b})")  # Triton: sign of the dividend
    return f"tl.where(({r} != 0) & (({r} < 0) != ({b} < 0)), {r} + {b}, {r})"


def _pow(em: Emitter, args, cc) -> str:
    if not _is_float(cc):
        raise NotImplementedError("integer pow is not covered by the CUDA "
                                  "expression kernel")
    return f"libdevice.pow({args[0]}, {args[1]})"


def _fmod(em: Emitter, args, cc) -> str:
    if _is_float(cc):
        return f"libdevice.fmod({args[0]}, {args[1]})"
    return f"({args[0]} % {args[1]})"


def _minmax(fn: str):
    def form(em: Emitter, args, cc) -> str:
        nan = f", {_NAN_ALL}" if _is_float(cc) else ""
        return f"tl.{fn}({args[0]}, {args[1]}{nan})"
    return form


def _max0(em: Emitter, args, cc) -> str:
    d = em.define(f"({args[0]} - {args[1]})")
    keep = f"({d} > 0) | ({d} != {d})" if _is_float(cc) else f"{d} > 0"
    return f"tl.where({keep}, {d}, 0)"


def _clamp(em: Emitter, args, cc) -> str:
    x, lo, hi = args
    nan = f", {_NAN_ALL}" if _is_float(cc) else ""
    return f"tl.minimum(tl.maximum({x}, {lo}{nan}), {hi}{nan})"


def _rounding(fn: str):
    def form(em: Emitter, args, cc) -> str:
        return f"libdevice.{fn}({args[0]})" if _is_float(cc) else args[0]
    return form


_NAMED = {
    "floordiv": _floordiv, "mod": _mod, "pow": _pow, "fmod": _fmod,
    "min": _minmax("minimum"), "max": _minmax("maximum"), "max0": _max0,
    "clamp": _clamp, "floor": _rounding("floor"), "ceil": _rounding("ceil"),
    "trunc": _rounding("trunc"), "rint": _rounding("rint"),
}


def params(analysis: Analysis) -> List[str]:
    """Kernel parameters for the leaves: ``p<slot>`` pointers and
    ``s<slot>`` scalars, in slot order."""
    return [f"p{i}" if isinstance(l, torch.Tensor) else f"s{i}"
            for i, l in enumerate(analysis.leaves)]


def jit_header(name: str, analysis: Analysis, first: Sequence[str],
               last: Sequence[str]) -> str:
    ps = params(analysis)
    scalars = [p for p in ps if p.startswith("s")]
    args = ", ".join([*first, *ps, *last])
    return (f"@triton.jit(do_not_specialize={scalars!r})\n"
            f"def {name}({args}):\n")


def body(exprs: Sequence[Expr], analysis: Analysis, types: Dict[int, str],
         result_codes: Sequence[str]) -> Tuple[List[str], List[str]]:
    """Lines that compute each of ``exprs`` over the block at ``offs``,
    every node of their union once, and the names holding the values,
    each in its result code."""
    em = Emitter(analysis, types)
    res = [em.cast(em.value(e), types[id(e)], c)
           for e, c in zip(exprs, result_codes)]
    return em.lines, res


def assign_multi_source(exprs: Sequence[Expr], analysis: Analysis,
                        types: Dict[int, str],
                        out_codes: Sequence[str]) -> str:
    """The kernel writing ``exprs[i]`` to output ``o<i>`` in type
    ``out_codes[i]``: every load and every node first, then the k stores."""
    lines, res = body(exprs, analysis, types, out_codes)
    outs = [f"o{i}" for i in range(len(exprs))]
    src = [_HEADER,
           jit_header("assign_kernel", analysis, outs,
                      ["n", "BLOCK: tl.constexpr"]),
           "    offs = tl.program_id(0).to(tl.int64) * BLOCK "
           "+ tl.arange(0, BLOCK)\n",
           "    mask = offs < n\n"]
    src += [f"    {line}\n" for line in lines]
    # tl.where broadcasts a leafless (scalar-only) value to the block
    src += [f"    tl.store({o} + offs, tl.where(mask, {r}, {r}), mask=mask)\n"
            for o, r in zip(outs, res)]
    return "".join(src)


def assign_source(expr: Expr, analysis: Analysis, types: Dict[int, str],
                  out_code: str) -> str:
    return assign_multi_source([expr], analysis, types, [out_code])


class _AssignKernel:
    def __init__(self, src: str):
        from .._build import triton_module

        if config.show_kernels:
            print(src)
        self.fn = triton_module(src).assign_kernel

    def launch(self, outs: Sequence[torch.Tensor], leaves: Sequence) -> None:
        import triton

        n = outs[0].numel()
        grid = (triton.cdiv(n, ASSIGN_BLOCK),)
        with torch.cuda.device(outs[0].device):
            self.fn[grid](*outs, *launch_args(leaves), n, BLOCK=ASSIGN_BLOCK,
                          num_warps=4)


def plain_values(exprs: Sequence[Expr], analysis: Analysis, types, leaves,
                 n: int, device) -> List[torch.Tensor]:
    """Each of ``exprs`` over n elements by the plain PyTorch ``emit``
    forms, nodes shared between them computed once."""
    env = EmitEnv({nid: leaves[s] for nid, s in analysis.slot_of.items()},
                  types, n, device)
    return [torch.broadcast_to(e.emit_cached(env), (n,)) for e in exprs]


def plain_value(expr: Expr, analysis: Analysis, types, leaves, n: int,
                device) -> torch.Tensor:
    """``expr`` over n elements by its plain PyTorch ``emit`` forms."""
    return plain_values([expr], analysis, types, leaves, n, device)[0]


def assign_plain(expr: Expr, analysis: Analysis, types, leaves,
                 out: torch.Tensor) -> None:
    """The kernel's plain PyTorch version."""
    out.copy_(plain_value(expr, analysis, types, leaves, out.numel(),
                          out.device))


def assign_multi_plain(exprs: Sequence[Expr], analysis: Analysis, types,
                       leaves, outs: Sequence[torch.Tensor]) -> None:
    """The k-output kernel's plain PyTorch version: every value before
    any store, and a value that shares memory with a target (a leaf that
    ``emit`` returns as it is) copied first, as the kernel loads all
    before it stores."""
    vals = plain_values(exprs, analysis, types, leaves, outs[0].numel(),
                        outs[0].device)
    mem = {o.untyped_storage().data_ptr() for o in outs}
    vals = [v.clone() if v.untyped_storage().data_ptr() in mem else v
            for v in vals]
    for o, v in zip(outs, vals):
        o.copy_(v)


def _launch(exprs: Sequence[Expr], analysis: Analysis, types, leaves,
            outs: Sequence[torch.Tensor]) -> None:
    key = ("assign",) + kernel_key(analysis, tuple(o.dtype for o in outs))

    def factory():
        return _AssignKernel(assign_multi_source(
            exprs, analysis, types, [code_of(o.dtype) for o in outs]))

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    k.launch(outs, leaves)


def assign(expr: Expr, analysis: Analysis, types, leaves,
           out: torch.Tensor) -> None:
    """Write the elementwise ``expr`` into ``out`` (1-D, contiguous)."""
    if out.device.type == "cpu":
        assign_plain(expr, analysis, types, leaves, out)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no expression kernel for {out.device}")
    if out.numel() == 0:
        return
    _launch([expr], analysis, types, leaves, [out])
    assign.launches += 1


#: launches of the generated expression kernel (not of its plain version)
assign.launches = 0


def assign_multi(exprs: Sequence[Expr], analysis: Analysis, types, leaves,
                 outs: Sequence[torch.Tensor]) -> None:
    """Write the elementwise ``exprs[i]`` into ``outs[i]`` (1-D,
    contiguous, one length and one device) in one launch."""
    device = outs[0].device
    if device.type == "cpu":
        assign_multi_plain(exprs, analysis, types, leaves, outs)
        return
    if device.type != "cuda":
        raise NotImplementedError(f"no expression kernel for {device}")
    if outs[0].numel() == 0:
        return
    _launch(exprs, analysis, types, leaves, outs)
    assign_multi.launches += 1


#: launches of the k-output kernel (not of its plain version)
assign_multi.launches = 0
