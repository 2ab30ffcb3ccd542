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
* the map-reduce bodies used by ``ops/triton_reduce.py``;
* with views in the tree (``expr/view.py``), the same kernels load at
  computed indices (V1): the emitter evaluates each node in an index
  context, and a view evaluates its inner expression at the index it
  computes (the XLA gathers of ``vexcl_tpu/expr/view.py:174-224,
  286-337`` and ``expr/pointer.py:32-35``).  Every load still comes
  before the first store; a target that is read beneath a view is
  written through a temporary (``compile.evaluate``);
* for a tree whose affine view reads with coefficient 1 on an axis
  before its innermost one (a transpose: ``reshape(x, dims, order)``
  whose last source axis is not the last output axis), the tiled
  assignment kernel (``assign_tiled_source``, chosen by ``tiled_view``
  from the structure and recorded in the key): one (TU, TL) tile of
  that axis and the innermost one a program, the view's leaves loaded
  with lanes fast along the axis it reads contiguously, its value moved
  to the output's order by a 2-D ``tl.trans`` (through shared memory),
  every other leaf loaded and every output stored with lanes fast along
  the innermost axis: whole 128-byte lines on both sides, where the 1-D
  kernel's neighbouring lanes would read addresses a row apart;
* the view-assignment kernel (V3, ``assign_to_view``): a value over a
  view's length stored at the indices the view computes into its
  vector, or combined there by an atomic add, min, max or (by
  compare-and-swap) multiply (the XLA scatters of
  ``vexcl_tpu/expr/view.py:66-100`` and ``ops/atomic.py:57-124``).  It
  is bound by memory: the value's leaves and the index read once, each
  element stored once; a permutation's stores land at random, one
  32-byte sector each.

Complex values (c64, c128) are (re, im) pairs of f32 or f64 variables:
a complex leaf crosses as a pointer to its real type (the memory of
``torch.view_as_real``), is loaded as a (BLOCK, 2) tile, so that a lane
moves its element's 8 or 16 contiguous bytes, and split (``tl.split``); a
complex target is stored through ``tl.join``; a complex scalar crosses as
two numbers.  The kernel covers ``+ - * /``, unary ``-``, ``== !=``, casts
between real and complex, ``where``, ``real``, ``imag``, ``conj`` and
``abs`` of complex values (``Emitter.complex_op``); division is Smith's
(XLA's form), so results agree with the plain form within rounding, not
bit for bit.  Every other operation on a complex value raises
``NotImplementedError`` on CUDA.

Every node is cast to the type the port inferred for it (``types.py``
follows the JAX package's promotion, not Triton's), scalar leaves are
passed in their own type (a Python float is passed as its 64 bits, since
Triton would pass it as f32), a float becomes an integer as
``node.convert`` and the JAX package convert it (truncated, NaN 0,
saturated at the type's limits, which ``Emitter._saturate`` compares
before the conversion: LLVM's ``fptosi`` is undefined out of range; a
memory-bound store of 2^24 f32 into i32 takes the plain ``.to()``'s time
within 1% on an H100, ``chip_smoke.py`` phase 16), and integer ``//``
and ``%`` are corrected
to floor semantics (Triton's are C's).  Integer ``**`` is PyTorch's
``powi``: square and multiply over the exponent's bits in the compute
type, wrapping, while any exponent of the block has bits left.  Booleans compute what PyTorch
computes on them: ``+`` is or and ``*`` is and (the form in i32 tested
against 0), orders compare 0 and 1, and ``-`` and unary ``-`` raise
TypeError.  A node outside this coverage (complex values beyond the
forms above, types without a Triton type) raises
``NotImplementedError`` on CUDA.

The kernel is bound by device memory bandwidth: it reads each leaf once
and writes each destination once, one 16-byte access per thread per leaf
at f32 with ``BLOCK`` 1024 and 4 warps (the Lorenz RK4 step at 2^22 f32:
117 MB, 0.0350 ms at 3.35 TB/s, against ~75 flops an element).
``assign`` and ``assign_multi`` are the wrappers: they launch the kernel
for CUDA tensors and run the trees' plain PyTorch forms (``Expr.emit``)
for CPU tensors.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .._build import Pointer, written
from ..cache import kernel_cache
from ..config import config
from ..ops import cuda_gather, cuda_scatter
from ..types import (COMPLEX_CODES, code_of, dtype_of_code, real_code,
                     scalar_code)
from .node import (_INT_WIDTH, Analysis, BinOp, CastExpr, ConstantTerminal,
                   EmitEnv, Expr, ScalarTerminal, UnOp, convert, int_edges)

__all__ = ["Emitter", "assign_source", "assign_multi_source", "assign",
           "assign_plain", "assign_multi", "assign_multi_plain",
           "assign_indexed", "assign_complex", "assign_to_view",
           "assign_to_view_plain",
           "assign_to_view_source", "plain_value", "plain_values",
           "kernel_key", "launch_key", "leaf_codes", "launch_args",
           "assign_tiled_source", "tiled_view",
           "ASSIGN_BLOCK", "ASSIGN_TILE", "BASE", "TARGET_MODES"]

ASSIGN_BLOCK = 1024
#: the tiled assignment kernel's tile: TU elements along the axis a
#: transposing view reads contiguously, TL along the output's innermost
#: axis, and the warps of a program
ASSIGN_TILE = (32, 32, 8)

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
    bits (``bits``), other floats as f32 (``float``), the rest as ints; a
    complex value as two of them, its real and imaginary parts (``cbits``
    for c128 and weak complex numbers, ``cfloat`` for c64)."""
    code = scalar_code(value)
    if code in ("f*", "f64"):
        return "bits"
    if code in ("f32", "f16", "bf16"):
        return "float"
    if code in ("c*", "c128"):
        return "cbits"
    if code == "c64":
        return "cfloat"
    return "int"


_F64 = struct.Struct("<d")
_I64 = struct.Struct("<q")


def _bits(value: float) -> int:
    return _I64.unpack(_F64.pack(value))[0]


def tensor_arg(t: torch.Tensor):
    """A tensor as a kernel argument: as it is, except a 0-d one (a
    ``_build.Pointer``: Triton would take it for a number) and a complex
    one (a pointer to its real type, the memory of
    ``torch.view_as_real``)."""
    if t.dtype.is_complex:
        return Pointer(t, t.dtype.to_real())
    return t if t.ndim else Pointer(t)


def launch_args(leaves: Sequence) -> List:
    """Kernel arguments for the leaves, in slot order: a tensor as
    ``tensor_arg`` gives it, a scalar as ``_scalar_kind`` says (a complex
    one as two arguments)."""
    out = []
    for leaf in leaves:
        t = type(leaf)
        if t is float:                  # a weak Python float: its bits
            out.append(_bits(leaf))
        elif t is int:
            out.append(leaf)
        elif isinstance(leaf, torch.Tensor):
            out.append(tensor_arg(leaf))
        else:
            kind = _scalar_kind(leaf)
            if kind == "bits":
                out.append(_bits(float(leaf)))
            elif kind == "float":
                out.append(float(leaf))
            elif kind == "cbits":
                v = complex(leaf)
                out += [_bits(v.real), _bits(v.imag)]
            elif kind == "cfloat":
                v = complex(leaf)
                out += [v.real, v.imag]
            else:
                out.append(int(leaf))
    return out


def kernel_key(analysis: Analysis, out_dtypes) -> tuple:
    """Cache key: the signature carries no leaf types (the JAX package
    leaves dtype to jit's retrace), so the key adds them, and the output
    types.  A compound op is part of the signature: its old value is a
    leaf of the tree."""
    return (analysis.sig, leaf_codes(analysis.leaves), out_dtypes,
            analysis.index_bits)


def leaf_codes(leaves: Sequence) -> tuple:
    """The leaves' types as the kernel sees them: a tensor's code (marked
    ``@`` for a 0-d one, which the kernel loads once), a scalar's."""
    return tuple((code_of(l.dtype) if l.ndim else code_of(l.dtype) + "@")
                 if isinstance(l, torch.Tensor) else scalar_code(l)
                 for l in leaves)


#: the index context of an elementwise body: the element's index and the
#: mask of the block's lanes that hold one
BASE = ("offs", "mask")


class Emitter:
    """Accumulates the straight-line body of one kernel.

    Every node is evaluated in an index context ``at``, a pair of
    variable names (index, mask): ``BASE`` for the element being written,
    and, beneath a view (``expr/view.py``), the index the view computed
    into its inner expression.  A value is memoized by (node, context), so
    a node read at two indices is emitted twice, and a leaf is loaded once
    per index it is read at."""

    def __init__(self, analysis: Analysis, types: Dict[int, str]):
        self.analysis = analysis
        self.types = types
        self.lines: List[str] = []
        self.temps: Dict = {}
        self._vals: Dict[tuple, str] = {}
        self._slots: Dict = {}
        self._n = 0
        self.at = BASE
        #: the type of computed indices: i32 where every size the views
        #: reach fits (``Analysis.index_bits``), which keeps the division
        #: of an unravel in 32 bits
        self.ity = ("tl.int32" if getattr(analysis, "index_bits", 64) == 32
                    else "tl.int64")
        #: (id(view), index variable) -> the coordinates of that context
        #: over the view's axes, where the kernel computed them itself, so
        #: that the view does not unravel its index by runtime counts
        self.coords: Dict[Tuple[int, str], List[str]] = {}
        #: the tiled kernel's transposing view and its load-order context
        #: (``tiled``), or None
        self.tile = None

    # -- variables ------------------------------------------------------
    def value(self, node: Expr, at: Tuple[str, str] = None) -> str:
        """The variable holding ``node``'s value in context ``at`` (the
        current one by default)."""
        at = self.at if at is None else at
        key = (id(node), at)
        v = self._vals.get(key)
        if v is None:
            prev, self.at = self.at, at
            try:
                v = node.emit_src(self)
            finally:
                self.at = prev
            self._vals[key] = v
        return v

    def tiled(self, view: Expr):
        """In the tiled assignment kernel, the transposing view's value in
        the output's order: evaluated in the load-order context (lanes fast
        along the axis it reads contiguously), then moved through a 2-D
        transpose, which Triton lowers through shared memory.  None for
        every other node and context."""
        if self.tile is None or self.tile[0] is not view or self.at != BASE:
            return None
        v = self.value(view, self.tile[1])
        boolean = self.types[id(view)] == "b1"
        if isinstance(v, tuple):
            return tuple(self._transposed(p, False) for p in v)
        return self._transposed(v, boolean)

    def _transposed(self, v: str, boolean: bool) -> str:
        # tl.where broadcasts a leafless (scalar-only) value to the block
        v = self.define(f"tl.where({self.tile[1][1]}, {v}, {v})")
        if boolean:
            v = self.define(f"{v}.to(tl.int8)")
        v = self.define(f"tl.reshape(tl.trans(tl.reshape({v}, (TL, TU))), "
                        "(BLOCK,))")
        return self.define(f"({v} != 0)") if boolean else v

    def define(self, src: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.lines.append(f"{name} = {src}")
        return name

    def bind(self, value):
        """``value`` (an expression text, or a complex pair of variables)
        as a variable or a pair of them."""
        return value if isinstance(value, tuple) else self.define(value)

    def cast(self, var, frm: str, to: str):
        """``var`` of type ``frm`` in type ``to``: an expression text, or
        for a complex ``to`` a pair of variables.  A complex value cast to
        a real type is its real part (as ``astype``), to bool whether
        either part is not 0; a real value cast to a complex type has 0
        as its imaginary part."""
        if frm in COMPLEX_CODES or to in COMPLEX_CODES:
            return self._cast_complex(var, frm, to)
        if dtype_of_code(frm) == dtype_of_code(to):
            return var
        if to == "b1":
            return f"({var} != 0)"
        if _is_float(frm) and not _is_float(to):
            return self._saturate(var, frm, to)
        return f"{var}.to({tl_type(to)})"

    def _saturate(self, var: str, frm: str, to: str) -> str:
        """A float of type ``frm`` as the integer type ``to``, as
        ``node.convert`` computes it: truncated, NaN 0, saturated at and
        beyond the type's range.  The limits are compared first (in f32,
        or f64 for f64; both exact there), and only a value inside them
        is converted, so the answer never rests on ``fptosi``'s undefined
        range."""
        src = "f64" if dtype_of_code(frm) == torch.float64 else "f32"
        x = self.define(var if dtype_of_code(frm) == dtype_of_code(src)
                        else f"{var}.to({tl_type(src)})")
        dt = dtype_of_code(to)
        lo, top = int_edges(dt)
        high = self.define(f"{x} >= {self.constant(top, src)}")
        under = self.define(f"{x} <= {self.constant(lo, src)}")
        safe = self.define(f"tl.where({high} | {under} | ({x} != {x}), "
                           f"{self.zero(src)}, {x})")
        v = self.define(f"{safe}.to({tl_type(to)})")
        info = torch.iinfo(dt)
        top_v = (self.define(f"tl.full([BLOCK], -1, tl.int64).to(tl.uint64, "
                             "bitcast=True)") if dt == torch.uint64
                 else self.constant(info.max, to))
        v = self.define(f"tl.where({high}, {top_v}, {v})")
        if not info.min:
            return v            # under the range: 0, as the safe value is
        return f"tl.where({under}, {self.constant(info.min, to)}, {v})"

    def _cast_complex(self, var, frm: str, to: str):
        rf, rt = real_code(frm), real_code(to)
        if frm in COMPLEX_CODES and to in COMPLEX_CODES:
            if dtype_of_code(rf) == dtype_of_code(rt):
                return var
            return tuple(self.define(self.cast(p, rf, rt)) for p in var)
        if frm in COMPLEX_CODES:
            re, im = var
            if to == "b1":
                return f"(({re} != 0) | ({im} != 0))"
            return self.cast(re, rf, to)
        return self.bind(self.cast(var, frm, rt)), self.zero(rt)

    def zero(self, code: str) -> str:
        """A block of zeros of a real float type, defined once a kernel."""
        key = ("zero", code)
        if key not in self.temps:
            self.temps[key] = self.constant(0.0, code)
        return self.temps[key]

    def where(self, cond: str, a, b):
        """``tl.where`` of two values, pairs part by part."""
        if isinstance(a, tuple):
            return tuple(self.define(f"tl.where({cond}, {x}, {y})")
                         for x, y in zip(a, b))
        return self.define(f"tl.where({cond}, {a}, {b})")

    # -- indices ----------------------------------------------------------
    def index(self) -> str:
        """The current context's index in the index type."""
        idx = self.at[0]
        if idx != BASE[0] or self.ity == "tl.int64":
            return idx
        key = ("ix", idx)
        if key not in self.temps:
            self.temps[key] = self.define(f"{idx}.to(tl.int32)")
        return self.temps[key]

    def index64(self) -> str:
        """The current context's index as i64 (``element_index``): the
        element's own index is i64, a computed one is in the index
        type."""
        idx = self.at[0]
        return idx if idx == BASE[0] else f"{idx}.to(tl.int64)"

    def param(self, node: Expr) -> str:
        """A view's runtime integer (a scalar leaf) in the index type,
        defined once per kernel."""
        key = ("param", id(node))
        if key not in self.temps:
            self.temps[key] = self.define(
                f"{self.value(node, BASE)}.to({self.ity})")
        return self.temps[key]

    def unravel(self, idx: str, counts: Sequence) -> List[str]:
        """Row-major coordinates of ``idx`` over axes of ``counts``
        (variables; the outermost count is not needed)."""
        out: List[str] = [""] * len(counts)
        r = idx
        for e in range(len(counts) - 1, 0, -1):
            out[e] = self.define(f"{r} % {counts[e]}")
            r = self.define(f"{r} // {counts[e]}")
        out[0] = r
        return out

    def fill(self, code: str) -> str:
        """The value ``jnp.take`` gives an index out of range: NaN, the
        least signed or the largest unsigned integer, True."""
        dt = dtype_of_code(code)
        if dt.is_floating_point:
            return self.constant(float("nan"), code)
        if dt.is_complex:
            # jnp.take's fill of a complex array: NaN + 0j
            return (self.constant(float("nan"), real_code(code)),
                    self.zero(real_code(code)))
        if dt == torch.bool:
            return self.constant(True, code)
        info = torch.iinfo(dt)
        if dt == torch.uint64:
            return self.define(f"tl.full([BLOCK], -1, tl.int64)"
                               ".to(tl.uint64, bitcast=True)")
        return self.constant(info.min if dt.is_signed else info.max, code)

    # -- leaves -----------------------------------------------------------
    def load(self, node: Expr):
        slot = self.analysis.slot_of[id(node)]
        leaf = self.analysis.leaves[slot]
        if not isinstance(leaf, torch.Tensor):
            return self.scalar(node)    # a 0-d CPU tensor, crossed as scalar
        code = self.types[id(node)]
        if code in COMPLEX_CODES:
            return self._load_complex(slot, leaf)
        if leaf.ndim == 0:
            # a 0-d tensor on the card: one load, broadcast like a scalar
            if slot not in self._slots:
                tl_type(self.types[id(node)])
                self.lines.append(f"x{slot} = tl.load(p{slot})")
                self._slots[slot] = f"x{slot}"
            return self._slots[slot]
        key = ("load", slot, self.at)
        if key not in self._slots:
            tl_type(self.types[id(node)])  # raises on uncovered types
            idx, mask = self.at
            var = f"x{slot}" if self.at == BASE else f"x{slot}_{self._n}"
            self._n += 1
            self.lines.append(f"{var} = tl.load(p{slot} + {idx}, mask={mask})")
            self._slots[key] = var
        return self._slots[key]

    def load_quad(self, node: Expr, row: str, mask: str) -> List[str]:
        """Row ``row`` of a tensor leaf read as rows of 4 elements (the
        image's patch table): one (BLOCK, 4) load, each lane's elements
        contiguous and 4-aligned, so that the card moves a 4-byte row in
        one 16-byte load (an 8-byte one in two), split into 4 variables."""
        slot = self.analysis.slot_of[id(node)]
        tl_type(self.types[id(node)])
        var = f"x{slot}_{self._n}"
        self._n += 1
        self.lines += [
            f"{var} = tl.load(p{slot} + ({row} * 4)[:, None] "
            f"+ tl.arange(0, 4)[None, :], mask={mask}[:, None])",
            # (BLOCK, 2, 2): [:, :, 0] holds elements 0 and 2
            f"{var}_a, {var}_b = tl.split(tl.reshape({var}, (BLOCK, 2, 2)))",
            f"{var}_0, {var}_2 = tl.split({var}_a)",
            f"{var}_1, {var}_3 = tl.split({var}_b)"]
        return [f"{var}_{k}" for k in range(4)]

    def _load_complex(self, slot: int, leaf: torch.Tensor):
        """A complex leaf, a pointer to its real type: (re, im) variables.
        A 0-d one is loaded once; a 1-D one as a (BLOCK, 2) tile at the
        context's index (i64: twice an i32 index may overflow), split into
        its parts."""
        key = ("load", slot, self.at) if leaf.ndim else slot
        if key not in self._slots:
            var = f"x{slot}" if self.at == BASE or not leaf.ndim \
                else f"x{slot}_{self._n}"
            self._n += 1
            if leaf.ndim == 0:
                self.lines += [f"{var}_re = tl.load(p{slot})",
                               f"{var}_im = tl.load(p{slot} + 1)"]
            else:
                idx, mask = self.at
                if idx != BASE[0]:
                    idx = f"{idx}.to(tl.int64)"
                self.lines += [
                    f"{var}_ri = tl.load(p{slot} + ({idx} * 2)[:, None] "
                    f"+ tl.arange(0, 2)[None, :], mask={mask}[:, None])",
                    f"{var}_re, {var}_im = tl.split({var}_ri)"]
            self._slots[key] = (f"{var}_re", f"{var}_im")
        return self._slots[key]

    def scalar(self, node: Expr):
        slot = self.analysis.slot_of[id(node)]
        if slot not in self._slots:
            value = self.analysis.leaves[slot]
            code = self.types[id(node)]
            kind = _scalar_kind(value)
            var = f"v{slot}"
            if kind in ("cbits", "cfloat"):
                rt = tl_type(real_code(code))
                parts = []
                for part in ("r", "i"):
                    src = (f"s{slot}{part}.to(tl.int64).to(tl.float64, "
                           "bitcast=True)" if kind == "cbits"
                           else f"s{slot}{part}")
                    if kind == "cfloat" or rt != "tl.float64":
                        src += f".to({rt})"
                    self.lines.append(f"{var}{part} = {src}")
                    parts.append(f"{var}{part}")
                self._slots[slot] = tuple(parts)
                return self._slots[slot]
            if kind == "bits":
                src = f"s{slot}.to(tl.int64).to(tl.float64, bitcast=True)"
            else:
                src = f"s{slot}.to({tl_type(code)})"
            self.lines.append(f"{var} = {src}")
            self._slots[slot] = var
        return self._slots[slot]

    def constant(self, value, code: str):
        if isinstance(value, complex):
            rc = real_code(code)
            return (self.constant(value.real, rc),
                    self.constant(value.imag, rc))
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
    def apply(self, form: str, args: List[str], cc: str, op: str,
              rc: str = None) -> str:
        """Expression text of ``form`` over ``args`` in compute type cc,
        giving a value of the result type ``rc`` (cc where omitted)."""
        rc = rc or cc
        if any(isinstance(a, tuple) for a in args):
            raise NotImplementedError(
                f"{op!r} on a complex value is not covered by the CUDA "
                "expression kernel")
        if cc == "b1":
            if op in _BOOL_REFUSED:
                raise TypeError(f"{op!r} does not accept booleans")
            if op in _BOOL_LOGIC or op in _BOOL_ORDER:
                # PyTorch's and jnp's booleans: + is or, * is and, as the
                # form's value in i32 tested against 0; an order compares
                # them as 0 and 1
                v = form.format(*[f"{a}.to(tl.int32)" for a in args])
                return v if op in _BOOL_ORDER else f"({v} != 0)"
        named = _NAMED.get(form)
        half = cc in ("bf16", "f16")
        if half and (named is not None or "libdevice." in form):
            # libdevice has no 16-bit forms: compute in f32, round back a
            # result of the 16-bit type (ldexp's exponent is an integer)
            args = [a if op == "ldexp" and i == 1 else f"{a}.to(tl.float32)"
                    for i, a in enumerate(args)]
            inner = named(self, args, "f32", "f32" if rc == cc else rc) \
                if named else form.format(*args)
            return f"({inner}).to({tl_type(rc)})" if rc == cc else inner
        if named is not None:
            return named(self, args, cc, rc)
        if "libdevice." in form and not _is_float(cc):
            raise NotImplementedError(
                f"{op!r} on {dtype_of_code(cc)} is not covered by the CUDA "
                "expression kernel")
        return form.format(*args)

    def complex_op(self, op: str, args: List[tuple], cc: str):
        """``op`` over complex pairs ``args`` in compute type cc: a pair,
        or a variable for ``abs``, ``real``, ``imag``, ``==`` and ``!=``.
        Division is Smith's algorithm, the scaled form XLA uses, with
        correctly rounded divides; a product may contract to an FMA."""
        d = self.define
        if op in ("add", "sub"):
            (ar, ai), (br, bi) = args
            s = "+" if op == "add" else "-"
            return d(f"{ar} {s} {br}"), d(f"{ai} {s} {bi}")
        if op == "mul":
            (ar, ai), (br, bi) = args
            return (d(f"{ar} * {br} - {ai} * {bi}"),
                    d(f"{ar} * {bi} + {ai} * {br}"))
        if op == "div":
            (ar, ai), (br, bi) = args
            big = d(f"tl.abs({br}) >= tl.abs({bi})")
            # |br| >= |bi|: r = bi / br, den = br + bi r,
            # (ar + ai r, ai - ar r) / den; else r = br / bi, den = bi + br r,
            # (ar r + ai, ai r - ar) / den
            r = d(f"libdevice.div_rn(tl.where({big}, {bi}, {br}), "
                  f"tl.where({big}, {br}, {bi}))")
            den = d(f"tl.where({big}, {br} + {bi} * {r}, {bi} + {br} * {r})")
            re = d(f"tl.where({big}, {ar} + {ai} * {r}, {ar} * {r} + {ai})")
            im = d(f"tl.where({big}, {ai} - {ar} * {r}, {ai} * {r} - {ar})")
            return d(f"libdevice.div_rn({re}, {den})"), \
                d(f"libdevice.div_rn({im}, {den})")
        if op == "neg":
            (ar, ai), = args
            return d(f"-{ar}"), d(f"-{ai}")
        if op == "eq":
            (ar, ai), (br, bi) = args
            return d(f"({ar} == {br}) & ({ai} == {bi})")
        if op == "ne":
            (ar, ai), (br, bi) = args
            return d(f"({ar} != {br}) | ({ai} != {bi})")
        if op == "real":
            return args[0][0]
        if op == "imag":
            return args[0][1]
        if op == "conj":
            (ar, ai), = args
            return ar, d(f"-{ai}")
        if op in ("abs", "fabs"):
            (ar, ai), = args
            return d(f"libdevice.hypot({ar}, {ai})")
        if op in ("round", "rint", "nearbyint"):
            return tuple(d(f"libdevice.rint({p})") for p in args[0])
        if op == "sign":
            # jnp.sign: x / |x| part by part, 0 at 0
            (ar, ai), = args
            h, z = d(f"libdevice.hypot({ar}, {ai})"), self.zero(real_code(cc))
            return tuple(d(f"tl.where({h} == 0, {z}, libdevice.div_rn({p}, "
                           f"{h}))") for p in (ar, ai))
        raise NotImplementedError(
            f"{op!r} on {dtype_of_code(cc)} is not covered by the CUDA "
            "expression kernel")


#: operators on booleans computed as their plain forms compute them (+
#: is or, * is and): the form's value in i32 tested against 0
_BOOL_LOGIC = ("add", "mul", "mad", "fma", "mad24", "mul24", "hadd")
#: orders, compared on booleans as 0 and 1
_BOOL_ORDER = ("lt", "le", "gt", "ge", "isgreater", "isgreaterequal",
               "isless", "islessequal")
#: operators PyTorch refuses on booleans
_BOOL_REFUSED = ("sub", "neg", "mix", "fdim", "abs_diff", "rhadd", "sign",
                 "smoothstep")


def _divisor(em: Emitter, b: str, cc) -> str:
    """The divisor with 0 (and, signed, -1) taken as 1: C's integer ``/``
    and ``%`` leave both undefined, where XLA defines them (a zero
    divisor: all ones and the dividend; -1: the wrapped negation and 0)
    and the callers select those results."""
    bad = f"({b} == 0) | ({b} == -1)" if _is_signed(cc) else f"{b} == 0"
    return em.define(f"tl.where({bad}, 1, {b})")


def _floordiv(em: Emitter, args, cc, rc=None) -> str:
    a, b = args
    if _is_float(cc):
        # jnp's _float_divmod: fmod-based, quotient rounded half away
        m = em.define(f"libdevice.fmod({a}, {b})")
        d = em.define(f"libdevice.div_rn({a} - {m}, {b})")
        d = em.define(f"tl.where(({m} != 0) & (({b} < 0) != ({m} < 0)), "
                      f"{d} - 1, {d})")
        return f"libdevice.round({d})"
    bs = _divisor(em, b, cc)
    q = em.define(f"({a} // {bs})")  # Triton: truncating, as in C
    if _is_signed(cc):
        q = em.define(f"tl.where({b} == -1, -({a}), {q})")
    # lax.div: all ones at a zero divisor
    q = em.define(f"tl.where({b} == 0, ~tl.zeros_like({q}), {q})")
    if not _is_signed(cc):
        return q
    # jnp.floor_divide: one less where the signs differ and lax.rem (the
    # dividend at a zero divisor) is not 0
    r = em.define(f"tl.where({b} == 0, {a}, {a} % {bs})")
    return (f"tl.where(({r} != 0) & ((({a} < 0) != ({b} < 0)) | "
            f"({b} == 0)), {q} - 1, {q})")


def _mod(em: Emitter, args, cc, rc=None) -> str:
    a, b = args
    if _is_float(cc):
        r = em.define(f"libdevice.fmod({a}, {b})")
    else:
        # jnp.remainder takes a zero divisor as 1: x % 0 is 0
        b = _divisor(em, b, cc)
        r = em.define(f"({a} % {b})")  # Triton: sign of the dividend
        if not _is_signed(cc):
            return r
    return f"tl.where(({r} != 0) & (({r} < 0) != ({b} < 0)), {r} + {b}, {r})"


def _pow(em: Emitter, args, cc, rc=None) -> str:
    if _is_float(cc):
        return f"libdevice.pow({args[0]}, {args[1]})"
    return _ipow(em, args, cc)


def _ipow(em: Emitter, args, cc) -> str:
    """Integer a ** b as PyTorch's ``powi``: square and multiply over the
    bits of b in the compute type (wrapping), the block looping while any
    of its exponents has bits left; a negative b gives 1 for a == 1, +-1
    for a == -1 by b's parity, else 0."""
    a, b = args
    ty = tl_type(cc)
    zeros = f"tl.zeros([BLOCK], {ty})"
    r = em.define(f"tl.full([BLOCK], 1, {ty})")
    p = em.define(f"{a} + {zeros}")
    e = em.define(f"{b} + {zeros}" if not _is_signed(cc)
                  else f"tl.where({b} < 0, 0, {b}) + {zeros}")
    em.lines += [f"while tl.max({e}, axis=0) > 0:",
                 f"    {r} = tl.where(({e} & 1) != 0, {r} * {p}, {r})",
                 f"    {p} = {p} * {p}",
                 f"    {e} = ({e} >> 1).to({ty})"]
    if not _is_signed(cc):
        return r
    neg = em.define(f"tl.where({a} == 1, 1, tl.where({a} == -1, "
                    f"tl.where(({b} & 1) != 0, -1, 1), 0)).to({ty})")
    return f"tl.where({b} < 0, {neg}, {r})"


def _fmod(em: Emitter, args, cc, rc=None) -> str:
    if _is_float(cc):
        return f"libdevice.fmod({args[0]}, {args[1]})"
    # jnp.fmod takes an integer zero divisor as 1: fmod(x, 0) is 0
    return f"({args[0]} % {_divisor(em, args[1], cc)})"


def _fmod_bool(em: Emitter, args, cc, rc=None) -> str:
    # jnp.fmod of two booleans (in i32) keeps a zero divisor: lax.rem(x, 0)
    return f"tl.where({args[1]} != 0, 0, {args[0]})"


def _sign(em: Emitter, args, cc, rc=None) -> str:
    """jnp.sign of a real value: NaN at NaN, a zero with its sign."""
    x = args[0]
    if _is_float(cc):
        one = em.define(f"tl.where({x} > 0, 1, -1).to({tl_type(cc)})")
        return f"tl.where(({x} == 0) | ({x} != {x}), {x}, {one})"
    if _is_signed(cc):
        return f"(({x} > 0).to({tl_type(cc)}) - ({x} < 0).to({tl_type(cc)}))"
    return f"({x} != 0).to({tl_type(cc)})"


def _minmax(fn: str):
    def form(em: Emitter, args, cc, rc=None) -> str:
        if cc == "b1":
            # booleans: the minimum is and, the maximum or
            return f"({args[0]} {'&' if fn == 'minimum' else '|'} {args[1]})"
        nan = f", {_NAN_ALL}" if _is_float(cc) else ""
        return f"tl.{fn}({args[0]}, {args[1]}{nan})"
    return form


def _max0(em: Emitter, args, cc, rc=None) -> str:
    d = em.define(f"({args[0]} - {args[1]})")
    keep = f"({d} > 0) | ({d} != {d})" if _is_float(cc) else f"{d} > 0"
    return f"tl.where({keep}, {d}, 0)"


def _clamp(em: Emitter, args, cc, rc=None) -> str:
    x, lo, hi = args
    if cc == "b1":
        return f"(({x} | {lo}) & {hi})"
    nan = f", {_NAN_ALL}" if _is_float(cc) else ""
    return f"tl.minimum(tl.maximum({x}, {lo}{nan}), {hi}{nan})"


def _rounding(fn: str):
    def form(em: Emitter, args, cc, rc=None) -> str:
        return f"libdevice.{fn}({args[0]})" if _is_float(cc) else args[0]
    return form


def _zeros(em: Emitter, args, cc, rc=None) -> str:
    # jnp.imag of a real value
    return (em.zero(cc) if _is_float(cc)
            else f"tl.zeros_like({args[0]})")


# -- the builtins' kernel forms --------------------------------------------

_UINT = {8: "tl.uint8", 16: "tl.uint16", 32: "tl.uint32", 64: "tl.uint64"}
_SINT = {32: "tl.int32", 64: "tl.int64"}


def _word(x: str, cc: str) -> str:
    """An integer of type cc as the i32 or i64 word libdevice's integer
    functions take: its bits, zero-extended from 8 and 16 bits."""
    w = _INT_WIDTH[cc]
    if w < 32:
        return f"{x}.to({_UINT[w]}, bitcast=True).to(tl.int32)"
    return f"{x}.to({_SINT[w]}, bitcast=True)"


def _popcount(em: Emitter, args, cc, rc) -> str:
    return f"libdevice.popc({_word(args[0], cc)}).to({tl_type(rc)})"


def _clz(em: Emitter, args, cc, rc) -> str:
    # lax.clz counts within the type: a zero-extended 8- or 16-bit word
    # has 32 - w more leading zeros
    w = _INT_WIDTH[cc]
    fix = f" - {32 - w}" if w < 32 else ""
    return f"(libdevice.clz({_word(args[0], cc)}){fix}).to({tl_type(rc)})"


def _rotate(em: Emitter, args, cc, rc) -> str:
    """A left rotation by s modulo the width, logical, in the unsigned
    word of the type (u32 for 8 and 16 bits)."""
    x, s = args
    w = _INT_WIDTH[cc]
    uw = _UINT[w]
    word = _UINT[max(w, 32)]
    ux = em.define(f"{x}.to({uw}, bitcast=True).to({word})")
    k = em.define(f"{s}.to({uw}, bitcast=True).to({word}) & {w - 1}")
    r = em.define(f"({ux} << {k}) | ({ux} >> (({w} - {k}) & {w - 1}))")
    return f"{r}.to({uw}).to({tl_type(rc)}, bitcast=True)"


def _sat(sub: bool):
    """add_sat, sub_sat: exact in a wider word and clamped, or (64 bits)
    the wrapped sum corrected where it overflowed."""
    def form(em: Emitter, args, cc, rc) -> str:
        a, b = args
        w = _INT_WIDTH[cc]
        op = "-" if sub else "+"
        if w < 64:
            info = torch.iinfo(dtype_of_code(cc))
            wide = "tl.int32" if w < 32 else "tl.int64"
            v = em.define(f"{a}.to({wide}) {op} {b}.to({wide})")
            return (f"tl.minimum(tl.maximum({v}, {info.min}), {info.max})"
                    f".to({tl_type(rc)})")
        s = em.define(f"{a} {op} {b}")
        if cc == "u64":
            if sub:
                return f"tl.where({b} > {a}, tl.zeros_like({s}), {s})"
            return f"tl.where({s} < {a}, ~tl.zeros_like({s}), {s})"
        if sub:
            up = f"({a} >= 0) & ({b} < 0) & ({s} < 0)"
            dn = f"({a} < 0) & ({b} > 0) & ({s} >= 0)"
        else:
            up = f"({a} > 0) & ({b} > 0) & ({s} < 0)"
            dn = f"({a} < 0) & ({b} < 0) & ({s} >= 0)"
        return (f"tl.where({up}, {(1 << 63) - 1}, tl.where({dn}, "
                f"{-(1 << 63)}, {s}))")
    return form


def _mulhi(em: Emitter, a: str, b: str, cc: str) -> str:
    """The high half of a * b in type cc: libdevice's mulhi for 32 and
    64 bits, a product in 32 bits for 8 and 16."""
    w = _INT_WIDTH[cc]
    if w >= 32:
        return em.define(f"libdevice.mulhi({a}, {b})")
    wide = "tl.int32" if _is_signed(cc) else "tl.uint32"
    return em.define(f"(({a}.to({wide}) * {b}.to({wide})) >> {w})"
                     f".to({tl_type(cc)})")


def _mul_hi(em: Emitter, args, cc, rc) -> str:
    return _mulhi(em, args[0], args[1], cc)


def _mad_hi(em: Emitter, args, cc, rc) -> str:
    # OpenCL: mul_hi(a, b) + c, wrapping
    return f"({_mulhi(em, args[0], args[1], cc)} + {args[2]})"


def _mad_sat(em: Emitter, args, cc, rc) -> str:
    """a * b + c on the exact product, saturated: in i64 for up to 32
    bits (u32 in u64, where the sum may carry), from mulhi's high word
    for 64."""
    a, b, c = args
    w = _INT_WIDTH[cc]
    info = torch.iinfo(dtype_of_code(cc))
    if w < 32 or cc == "i32":
        v = em.define(f"{a}.to(tl.int64) * {b}.to(tl.int64) + "
                      f"{c}.to(tl.int64)")
        return (f"tl.minimum(tl.maximum({v}, {info.min}), {info.max})"
                f".to({tl_type(rc)})")
    if cc == "u32":
        p = em.define(f"{a}.to(tl.uint64) * {b}.to(tl.uint64)")
        s = em.define(f"{p} + {c}.to(tl.uint64)")
        return (f"tl.where(({s} < {p}) | ({s} > {info.max}), {info.max}, "
                f"{s}).to(tl.uint32)")
    hi = _mulhi(em, a, b, cc)
    p = em.define(f"{a} * {b}")
    s = em.define(f"{p} + {c}")
    if cc == "u64":
        return (f"tl.where(({hi} != 0) | ({s} < {p}), ~tl.zeros_like({s}), "
                f"{s})")
    carry = em.define(f"({s}.to(tl.uint64, bitcast=True) < "
                      f"{p}.to(tl.uint64, bitcast=True)).to(tl.int64)")
    top = em.define(f"{hi} + ({c} >> 63) + {carry}")
    return (f"tl.where({top} == ({s} >> 63), {s}, tl.where({top} < 0, "
            f"{info.min}, {info.max}))")


def _upsample(em: Emitter, args, cc, rc) -> str:
    hi, lo = args
    w, ty = _INT_WIDTH[cc], tl_type(rc)
    return f"(({hi}.to({ty}) << {w}) | {lo}.to({ty}))"


def _msb(em: Emitter, args, cc, rc) -> str:
    x = args[0]
    if cc == "b1" or not (_is_float(cc) or _is_signed(cc)):
        return f"tl.zeros_like({x}).to(tl.int32)"
    return f"({x} < 0).to(tl.int32)"


def _step(em: Emitter, args, cc, rc) -> str:
    e, x = args
    if cc == "b1":
        e, x = f"{e}.to(tl.int32)", f"{x}.to(tl.int32)"
    return f"tl.where({x} < {e}, 0, 1).to({tl_type(rc)})"


def _magnitude(ge: bool):
    def form(em: Emitter, args, cc, rc) -> str:
        a, b = args
        if cc == "b1":
            return f"({a} {'|' if ge else '&'} {b})"
        if _is_float(cc) or _is_signed(cc):
            ma, mb = f"tl.abs({a})", f"tl.abs({b})"
        else:
            ma, mb = a, b
        return f"tl.where({ma} {'>=' if ge else '<='} {mb}, {a}, {b})"
    return form


def _smoothstep(em: Emitter, args, cc, rc) -> str:
    # the differences in the operands' type (integers wrap), the rest in
    # the result's
    e0, e1, x = args
    z, one = em.constant(0.0, rc), em.constant(1.0, rc)
    ty = tl_type(rc)
    t = em.define(f"libdevice.div_rn(({x} - {e0}).to({ty}), "
                  f"({e1} - {e0}).to({ty}))")
    t = em.define(f"tl.minimum(tl.maximum({t}, {z}, {_NAN_ALL}), {one}, "
                  f"{_NAN_ALL})")
    return f"{t} * {t} * (3.0 - 2.0 * {t})"


def _fract(em: Emitter, args, cc, rc) -> str:
    x = args[0]
    below = em.constant(1.0 - torch.finfo(dtype_of_code(cc)).eps / 2, cc)
    return f"tl.minimum({x} - libdevice.floor({x}), {below}, {_NAN_ALL})"


def _ilogb(em: Emitter, args, cc, rc) -> str:
    # libdevice's ilogb: INT_MIN at 0 and NaN, INT_MAX at infinity
    return f"libdevice.ilogb({args[0]})"


#: (mantissa bits, exponent mask, bias of frexp's exponent, int type)
_FREXP = {"f32": (23, 0xFF, 126, "tl.int32"),
          "f64": (52, 0x7FF, 1022, "tl.int64")}


def _frexp(em: Emitter, x: str, cc: str):
    """(mantissa, exponent as i32) of frexp(x) from x's bits: a subnormal
    scaled by 2^(bits + 1) first; 0, infinities and NaN as they are with
    exponent 0."""
    key = ("frexp", x)
    if key in em.temps:
        return em.temps[key]
    bits, emask, bias, it = _FREXP["f64" if cc == "f*" else cc]
    scale = em.constant(float(2 ** (bits + 1)), cc)
    e = em.define(f"({x}.to({it}, bitcast=True) >> {bits}) & {emask}")
    sub = em.define(f"({e} == 0) & ({x} != 0)")
    xs = em.define(f"tl.where({sub}, {x} * {scale}, {x})")
    b = em.define(f"{xs}.to({it}, bitcast=True)")
    es = em.define(f"(({b} >> {bits}) & {emask}) - tl.where({sub}, "
                   f"{bias + bits + 1}, {bias})")
    special = em.define(f"({x} == 0) | ({e} == {emask})")
    clear = ~(emask << bits)
    mant = em.define(f"(({b} & {clear}) | ({bias} << {bits}))"
                     f".to({tl_type(cc)}, bitcast=True)")
    em.temps[key] = (em.define(f"tl.where({special}, {x}, {mant})"),
                     em.define(f"tl.where({special}, 0, {es}).to(tl.int32)"))
    return em.temps[key]


def _frexp_mant(em: Emitter, args, cc, rc) -> str:
    return _frexp(em, args[0], cc)[0]


def _frexp_exp(em: Emitter, args, cc, rc) -> str:
    return _frexp(em, args[0], cc)[1]


def _gamma_sign(em: Emitter, args, cc, rc) -> str:
    x = args[0]
    return (f"tl.where(({x} > 0) | (libdevice.floor({x} * 0.5) * 2 == "
            f"libdevice.floor({x})), 1, -1).to(tl.int64)")


def _nan(em: Emitter, args, cc, rc) -> str:
    return em.constant(float("nan"), "f32")


def _ldexp(em: Emitter, args, cc, rc) -> str:
    # the exponent arrives as i64; beyond +-100000 every result is 0 or
    # infinite, so it is clamped into i32 first
    x, n = args
    return (f"libdevice.ldexp({x}, tl.minimum(tl.maximum({n}, -100000), "
            f"100000).to(tl.int32))")


def _pi(fn: str, inverse: bool):
    """sin(pi x), cos(pi x), tan(pi x) (``pi:fn``) and asin(x) / pi ...
    (``/pi:fn``), spelled as their plain forms: pi rounded to the compute
    type."""
    def form(em: Emitter, args, cc, rc) -> str:
        pi = em.constant(math.pi, cc)
        if inverse:
            return (f"libdevice.div_rn(libdevice.{fn}("
                    f"{', '.join(args)}), {pi})")
        return f"libdevice.{fn}({pi} * {args[0]})"
    return form


def _scaled(factor: float):
    def form(em: Emitter, args, cc, rc) -> str:
        return f"({args[0]} * {em.constant(factor, cc)})"
    return form


def _signbit(em: Emitter, args, cc, rc) -> str:
    x = args[0]
    if _is_float(cc):
        return f"(libdevice.signbit({x}) != 0)"
    if _is_signed(cc):
        return f"({x} < 0)"
    return f"(tl.zeros_like({x}) != 0)"


def _isnormal(em: Emitter, args, cc, rc) -> str:
    x = args[0]
    if _is_float(cc):
        return f"((tl.abs({x}) < float('inf')) & ({x} != 0))"
    return f"({x} != 0)"


def _rootn(em: Emitter, args, cc, rc) -> str:
    x, n = args
    one = em.constant(1.0, cc)
    s = em.define(_sign(em, [x], cc))
    return (f"{s} * libdevice.pow(tl.abs({x}), "
            f"libdevice.div_rn({one}, {n}))")


def _tgamma(em: Emitter, args, cc, rc) -> str:
    """exp(lgamma(x)) for x > 0, else the reflection formula."""
    x = args[0]
    pi, one = em.constant(math.pi, cc), em.constant(1.0, cc)
    pos = em.define(f"libdevice.exp(libdevice.lgamma({x}))")
    den = em.define(f"libdevice.sin({pi} * {x}) * "
                    f"libdevice.exp(libdevice.lgamma({one} - {x}))")
    return f"tl.where({x} > 0, {pos}, libdevice.div_rn({pi}, {den}))"


#: the asymptotic series of digamma (PyTorch's calc_digamma, Cephes)
_DIGAMMA_A = (8.33333333333333333333E-2, -2.10927960927960927961E-2,
              7.57575757575757575758E-3, -4.16666666666666666667E-3,
              3.96825396825396825397E-3, -8.33333333333333333333E-3,
              8.33333333333333333333E-2)


def _digamma(em: Emitter, args, cc, rc) -> str:
    """digamma as PyTorch's CUDA ``calc_digamma`` computes it (the
    derivative of lgamma, ``builtins.DIGAMMA``): +-inf at -+0, NaN at the
    negative integers, the reflection -pi / tan(pi r) (r the fraction of
    x, in f64) for x < 0 with x taken to 1 - x, 1/x subtracted while x is
    below 10 (at most 10 rounds), then psi(10) exactly at 10, else log x -
    1/(2x) - the series in 1/x^2 (its terms dropped from 1e17)."""
    x = args[0]
    d, ty = em.define, tl_type(cc)
    one, zero = em.constant(1.0, cc), em.zero(cc)
    neg = d(f"{x} < 0")
    r = d(f"({x} - libdevice.trunc({x})).to(tl.float64)")
    pi = math.pi
    acc = d(f"tl.where({neg}, (-{pi!r} / libdevice.tan({pi!r} * {r}))"
            f".to({ty}), {zero})")
    y = d(f"tl.where({neg}, {one} - {x}, {x})")
    for _ in range(10):
        small = d(f"{y} < 10.0")
        acc = d(f"tl.where({small}, {acc} - libdevice.div_rn({one}, {y}), "
                f"{acc})")
        y = d(f"tl.where({small}, {y} + {one}, {y})")
    z = d(f"libdevice.div_rn({one}, {y} * {y})")
    poly = zero
    for a in _DIGAMMA_A:
        poly = d(f"{poly} * {z} + {em.constant(a, cc)}")
    series = d(f"tl.where({y} < 1.0e17, {z} * {poly}, {zero})")
    far = d(f"libdevice.log({y}) - libdevice.div_rn("
            f"{em.constant(0.5, cc)}, {y}) - {series} + {acc}")
    v = d(f"tl.where({y} == 10.0, {acc} + "
          f"{em.constant(2.25175258906672110764, cc)}, {far})")
    v = d(f"tl.where({neg} & ({x} == libdevice.trunc({x})), "
          f"{em.constant(float('nan'), cc)}, {v})")
    # +-0 gives -+inf (the sign read from the bits: -x may be 0 - x)
    inf = em.constant(float("inf"), cc)
    return (f"tl.where({x} == 0, tl.where(libdevice.signbit({x}) != 0, "
            f"{inf}, -{inf}), {v})")


_NAMED = {
    "digamma": _digamma,
    "one_below": lambda em, args, cc, rc=None: em.constant(
        1.0 - torch.finfo(dtype_of_code(cc)).eps / 2, cc),
    "real": lambda em, args, cc, rc=None: args[0],
    "conj": lambda em, args, cc, rc=None: args[0], "imag": _zeros,
    "floordiv": _floordiv, "mod": _mod, "pow": _pow, "fmod": _fmod,
    "fmod_bool": _fmod_bool, "sign": _sign,
    "min": _minmax("minimum"), "max": _minmax("maximum"), "max0": _max0,
    "clamp": _clamp, "floor": _rounding("floor"), "ceil": _rounding("ceil"),
    "trunc": _rounding("trunc"), "rint": _rounding("rint"),
    "popcount": _popcount, "clz": _clz, "rotate": _rotate,
    "add_sat": _sat(False), "sub_sat": _sat(True), "mul_hi": _mul_hi,
    "mad_hi": _mad_hi, "mad_sat": _mad_sat, "upsample": _upsample,
    "msb": _msb, "step": _step, "maxmag": _magnitude(True),
    "minmag": _magnitude(False), "smoothstep": _smoothstep,
    "fract": _fract, "ilogb": _ilogb, "frexp_mant": _frexp_mant,
    "frexp_exp": _frexp_exp, "gamma_sign": _gamma_sign, "nan": _nan,
    "ldexp": _ldexp, "isnormal": _isnormal, "signbit": _signbit,
    "rootn": _rootn,
    "tgamma": _tgamma, "degrees": _scaled(180.0 / math.pi),
    "radians": _scaled(math.pi / 180.0),
    **{f"pi:{fn}": _pi(fn, False) for fn in ("sin", "cos", "tan")},
    **{f"/pi:{fn}": _pi(fn, True) for fn in ("asin", "acos", "atan",
                                            "atan2")},
}


def params(analysis: Analysis) -> List[str]:
    """Kernel parameters for the leaves: ``p<slot>`` pointers and
    ``s<slot>`` scalars (``s<slot>r``, ``s<slot>i``: a complex one's
    parts), in slot order."""
    out = []
    for i, l in enumerate(analysis.leaves):
        if isinstance(l, torch.Tensor):
            out.append(f"p{i}")
        elif _scalar_kind(l) in ("cbits", "cfloat"):
            out += [f"s{i}r", f"s{i}i"]
        else:
            out.append(f"s{i}")
    return out


def jit_header(name: str, analysis: Analysis, first: Sequence[str],
               last: Sequence[str], ints: Sequence[str] = ()) -> str:
    """The ``@triton.jit`` line and signature; the scalar leaves and the
    runtime ``ints`` are not specialised (one compile for every value)."""
    ps = params(analysis)
    scalars = [p for p in ps if p.startswith("s")] + list(ints)
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


def store_line(o: str, r) -> str:
    """The store of the value ``r`` (a variable, or a complex pair) into
    output ``o`` at ``offs`` (i64), lanes ``mask``; ``tl.where`` broadcasts
    a leafless (scalar-only) value to the block.  A complex output is a
    pointer to its real type: the parts are joined into a (BLOCK, 2) tile,
    each lane storing its element's contiguous bytes."""
    if isinstance(r, tuple):
        re, im = (f"tl.where(mask, {p}, {p})" for p in r)
        return (f"tl.store({o} + (offs * 2)[:, None] + tl.arange(0, 2)"
                f"[None, :], tl.join({re}, {im}), mask=mask[:, None])")
    return f"tl.store({o} + offs, tl.where(mask, {r}, {r}), mask=mask)"


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
    src += [f"    {store_line(o, r)}\n" for o, r in zip(outs, res)]
    return "".join(src)


def assign_source(expr: Expr, analysis: Analysis, types: Dict[int, str],
                  out_code: str) -> str:
    return assign_multi_source([expr], analysis, types, [out_code])


def tiled_view(exprs: Sequence[Expr]):
    """The view that makes an assignment kernel tiled: the first affine
    view, in preorder, reached from the roots through elementwise nodes
    only (so read at the element's own index) whose ``tiled_axis`` is an
    axis: (its ordinal among the views reached, the view, that axis), or
    None.  A function of the trees' structure only (the axis markers are
    part of the signature)."""
    from .view import _View

    seen, k = set(), 0
    stack = list(reversed(exprs))
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, _View):
            u = node.tiled_axis()
            if u is not None:
                return k, node, u
            k += 1
            continue
        stack.extend(reversed(node.children))
    return None


def tiled_programs(tile) -> int:
    """The tiled kernel's grid: the other axes' coordinates times the
    (TU, TL) tiles over the view's loaded and innermost axes."""
    _, view, u = tile
    counts = [c for c, _, _, _ in view.axes]
    tu, tl_, _ = ASSIGN_TILE
    grid = -(-counts[u] // tu) * -(-counts[-1] // tl_)
    for e, c in enumerate(counts[:-1]):
        if e != u:
            grid *= c
    return grid


def assign_tiled_source(exprs: Sequence[Expr], analysis: Analysis,
                        types: Dict[int, str], out_codes: Sequence[str],
                        tile) -> str:
    """The assignment kernel over (TU, TL) tiles of a transposing view's
    loaded axis u and its innermost axis (``tiled_view``), one tile a
    program, the other axes over the grid.  The view's leaves are loaded
    with lanes fast along u (``offs_t``, ``mask_t``), where it reads
    contiguously; its value is transposed to the output's order
    (``Emitter.tiled``); every other node is evaluated, and each output
    stored, with lanes fast along the innermost axis (``offs``, ``mask``),
    so both sides move whole lines."""
    _, view, u = tile
    em = Emitter(analysis, types)
    ity = em.ity
    _, counts, _, _ = view.emit_params(em)
    last = len(view.axes) - 1
    others = [e for e in range(last) if e != u]
    if u == 0:
        # the outermost count is not a parameter of the view: n / the rest
        rest = counts[1]
        for c in counts[2:]:
            rest = em.define(f"{rest} * {c}")
        counts[0] = em.define(f"n.to({ity}) // {rest}")
    # the output's row-major strides over the view's axes
    ost: List = [None] * (last + 1)
    stride = None
    for e in range(last - 1, -1, -1):
        stride = counts[e + 1] if stride is None else em.define(
            f"{stride} * {counts[e + 1]}")
        ost[e] = stride
    cu, cl = counts[u], counts[last]
    pid = em.define(f"tl.program_id(0).to({ity})")
    ntl = em.define(f"({cl} + TL - 1) // TL")
    ntu = em.define(f"({cu} + TU - 1) // TU")
    tlid = em.define(f"{pid} % {ntl}")
    r = em.define(f"{pid} // {ntl}")
    tuid = em.define(f"{r} % {ntu}")
    r = em.define(f"{r} // {ntu}")
    oc = {}
    for i, e in enumerate(reversed(others)):
        if i == len(others) - 1:
            oc[e] = r
        else:
            oc[e] = em.define(f"{r} % {counts[e]}")
            r = em.define(f"{r} // {counts[e]}")
    obase = "0"
    for e in others:
        obase = em.define(f"{obase} + {oc[e]} * {ost[e]}")
    lane = em.define(f"tl.arange(0, BLOCK).to({ity})")
    for name, ul, ll in (("", f"{lane} // TL", f"{lane} % TL"),
                         ("_t", f"{lane} % TU", f"{lane} // TU")):
        cu_v = em.define(f"{tuid} * TU + {ul}")
        cl_v = em.define(f"{tlid} * TL + {ll}")
        em.lines.append(f"mask{name} = ({cu_v} < {cu}) & ({cl_v} < {cl})")
        flat = f"{obase} + {cu_v} * {ost[u]} + {cl_v}"
        em.lines.append(f"offs{name} = ({flat}).to(tl.int64)" if not name
                        else f"offs{name} = {flat}")
        if name:
            em.coords[(id(view), "offs_t")] = [
                cu_v if e == u else cl_v if e == last else oc[e]
                for e in range(last + 1)]
    em.tile = (view, ("offs_t", "mask_t"))
    res = [em.cast(em.value(e), types[id(e)], c)
           for e, c in zip(exprs, out_codes)]
    outs = [f"o{i}" for i in range(len(exprs))]
    src = [_HEADER,
           jit_header("assign_tiled_kernel", analysis, outs,
                      ["n", "TU: tl.constexpr", "TL: tl.constexpr",
                       "BLOCK: tl.constexpr"])]
    src += [f"    {line}\n" for line in em.lines]
    src += [f"    {store_line(o, r)}\n" for o, r in zip(outs, res)]
    return "".join(src)


class _AssignKernel:
    """A generated kernel over n elements, ``BLOCK`` a program: the
    assignment kernels and the view-assignment kernel; with ``tiled``,
    the tiled assignment kernel, one (TU, TL) tile a program.  The kernel
    cache's entry: it holds the launcher (``_build.TritonLauncher``, whose
    records keep the compiled kernel per argument class) and the
    constexpr values, so a call costs its arguments and one launch."""

    def __init__(self, src: str, name: str = "assign_kernel",
                 tiled: bool = False, complex_: bool = False,
                 shape: Tuple[int, int] = (ASSIGN_BLOCK, 4)):
        from .._build import TritonLauncher, triton_module

        if config.show_kernels:
            print(src)
        self.tiled = tiled
        #: the kernel carries a complex value (its launches count on
        #: ``assign_complex``)
        self.complex = complex_
        if tiled:
            tu, tl_, warps = ASSIGN_TILE
            self.consts = (tu, tl_, tu * tl_)       # TU, TL, BLOCK
        else:
            self.consts, warps = (shape[0],), shape[1]
        self.launcher = TritonLauncher(getattr(triton_module(src), name),
                                       warps)

    def launch(self, outs: Sequence[torch.Tensor], leaves: Sequence,
               n: int, programs: int = 0) -> None:
        grid = (programs,) if self.tiled else (-(-n // self.consts[0]),)
        self.launcher(grid, [*map(tensor_arg, outs), *launch_args(leaves)],
                      (n,), self.consts, outs[0].device)
        written(*outs)


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
    out.copy_(convert(plain_value(expr, analysis, types, leaves,
                                  out.numel(), out.device),
                      code_of(out.dtype)))


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
        o.copy_(convert(v, code_of(o.dtype)))


def launch_key(exprs: Sequence[Expr], analysis: Analysis, out_dtypes):
    """(the kernel cache's key of the assignment kernel of ``exprs`` into
    outputs of ``out_dtypes``, the tiled form's view or None): a function
    of the analysis and the types, which a caller that keeps the analysis
    (``generator.Kernel``) keeps too."""
    # the tiled form is a function of the structure: its choice (which
    # view, which axis) is part of the key, and a tiled kernel that fails
    # raises
    tile = tiled_view(exprs) if analysis.indexed else None
    form = None if tile is None else ("tiled", tile[0], tile[2])
    return ("assign", form) + kernel_key(analysis, tuple(out_dtypes)), tile


def launch_shape(exprs: Sequence[Expr]) -> Tuple[int, int]:
    """(BLOCK, warps) of the assignment kernel of ``exprs``: the first
    ``Expr.kernel_shape`` a node of the trees gives, in preorder, else
    ``ASSIGN_BLOCK`` elements over 4 warps.  A function of the trees'
    structure, so of the kernel's key."""
    seen, stack = set(), list(reversed(exprs))
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if node.kernel_shape is not None:
            return node.kernel_shape
        stack.extend(reversed(node.children))
    return ASSIGN_BLOCK, 4


def _launch(exprs: Sequence[Expr], analysis: Analysis, types, leaves,
            outs: Sequence[torch.Tensor], keyed=None) -> None:
    key, tile = keyed or launch_key(exprs, analysis,
                                    [o.dtype for o in outs])

    def factory():
        codes = [code_of(o.dtype) for o in outs]
        if tile is None:
            src = assign_multi_source(exprs, analysis, types, codes)
        else:
            src = assign_tiled_source(exprs, analysis, types, codes, tile)
        # the emitter has typed every node of the trees by now
        cplx = any(c in COMPLEX_CODES for c in [*codes, *types.values()])
        if tile is None:
            return _AssignKernel(src, complex_=cplx,
                                 shape=launch_shape(exprs))
        return _AssignKernel(src, "assign_tiled_kernel", tiled=True,
                             complex_=cplx)

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    k.launch(outs, leaves, outs[0].numel(),
             tiled_programs(tile) if tile is not None else 0)
    return k


def _gather_operands(expr: Expr, analysis: Analysis, types, leaves,
                     out: torch.Tensor):
    """(index, source) where ``expr`` is exactly a gather through a
    permutation that ``cuda_gather.route`` sends to the CUDA form: a leaf
    index of i32 or i64 and a contiguous 1-D leaf source of ``out``'s type
    (f32, f64, i32, i64); else None.  The form reads the index and the
    source before it writes ``out``, so either may share out's memory."""
    from .view import PermutationView

    if not isinstance(expr, PermutationView) \
            or dtype_of_code(types[id(expr)]) != out.dtype:
        return None
    n = out.numel()
    # the extent as the analysis took it (a lazy one with its parameter)
    extent = int(leaves[analysis.slot_of[id(expr.children[2])]])
    idx = _leaf_tensor(expr.children[1], analysis, leaves, n,
                       (torch.int32, torch.int64), out.device)
    if idx is None or not cuda_gather.route(out.dtype, extent, n,
                                            idx.dtype):
        return None
    src = _leaf_tensor(expr.children[0], analysis, leaves, extent,
                       (out.dtype,), out.device)
    return None if src is None else (idx, src)


#: the form of an assignment that is exactly a gather at the flat index of
#: two coordinate arrays (``_View.flat_coords``), forced: "fused" the
#: gather form's fused variant (raising where it does not take the table
#: or the coordinates), "v1" V1; None leaves it to
#: ``cuda_gather.index_route``
INDEX_GATHER = None


def _index_gather_operands(expr: Expr, analysis: Analysis, types, leaves,
                           out: torch.Tensor):
    """(table, coordinates) where ``expr`` is exactly a gather at the flat
    index of two coordinate arrays (``_View.flat_coords``: a nearest 2-D
    image sample, ``slicer[i, j]``), of ``out``'s type from a contiguous
    1-D leaf table of that type, the coordinates leaves the fused variant
    takes (``_fused_coords``), and ``cuda_gather.index_route`` (or
    ``INDEX_GATHER``) sends it to the gather form's fused variant; else
    None.  Every index is in range by construction."""
    from .view import _View

    if INDEX_GATHER == "v1" or not isinstance(expr, _View) \
            or expr.flat_coords() is None:
        return None
    n = out.numel()
    src_len = expr.child_sizes(n)[0]
    table = _leaf_tensor(expr.children[0], analysis, leaves, src_len,
                         (out.dtype,), out.device)
    if dtype_of_code(types[id(expr)]) != out.dtype:
        table = None
    coords = _fused_coords(expr, analysis, leaves, out)
    if INDEX_GATHER is None:
        taken = table is not None and coords is not None \
            and cuda_gather.index_route(out.dtype, src_len, n)
        return (table, coords) if taken else None
    if table is None or not cuda_gather.takes(out.dtype, src_len, n):
        raise NotImplementedError(
            f"the gather form does not take {out.dtype} tables of "
            f"{src_len} elements into {n}")
    if coords is None:
        raise NotImplementedError(
            "the fused gather takes two leaf coordinate arrays of one type")
    return table, coords


def _fused_coords(view: Expr, analysis: Analysis, leaves,
                  out: torch.Tensor):
    """The fused variant's ``cuda_gather.Coords`` where ``view``'s flat
    index is that of two contiguous leaf arrays of one type of
    ``cuda_gather.COORD_TYPES`` (float coordinates of an image, integer
    keys of a slicer: ``_View.flat_coords``); else None."""
    a, b, dims, strides, base, rounded = view.flat_coords()
    n = out.numel()
    types = [t for t in cuda_gather.COORD_TYPES
             if t.is_floating_point == rounded]
    ta = _leaf_tensor(a, analysis, leaves, n, types, out.device)
    tb = None if ta is None else _leaf_tensor(b, analysis, leaves, n,
                                              (ta.dtype,), out.device)
    if tb is None:
        return None
    return cuda_gather.Coords(ta, tb, tuple(dims), tuple(strides), base)


def assign(expr: Expr, analysis: Analysis, types, leaves,
           out: torch.Tensor) -> None:
    """Write the elementwise ``expr`` into ``out`` (1-D, contiguous): a
    gather through a permutation that ``cuda_gather.route`` takes in one
    call of the CUDA form (``_gather_operands``); a gather at the flat
    index of two coordinate arrays that ``cuda_gather.index_route`` takes
    in one call of the form's fused variant (``_index_gather_operands``);
    else in one launch of the generated kernel."""
    if out.device.type == "cpu":
        assign_plain(expr, analysis, types, leaves, out)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no expression kernel for {out.device}")
    if out.numel() == 0:
        return
    ops = _gather_operands(expr, analysis, types, leaves, out)
    if ops is not None:
        cuda_gather.gather_ranges(out, *ops)
        return
    ops = _index_gather_operands(expr, analysis, types, leaves, out)
    if ops is not None:
        table, coords = ops
        cuda_gather.gather_coords(out, coords, table)
        return
    if _launch([expr], analysis, types, leaves, [out]).complex:
        assign_complex.launches += 1
    elif analysis.indexed:
        assign_indexed.launches += 1
    else:
        assign.launches += 1


#: launches of the generated expression kernel whose tree reads through no
#: view and carries no complex value (not of its plain version)
assign.launches = 0


class _Launches:
    """The launch count of a kernel form that shares a wrapper."""

    launches = 0


#: launches of ``assign`` whose tree reads through a view (V1: loads at
#: computed indices) and carries no complex value (not of its plain
#: version)
assign_indexed = _Launches()

#: launches of ``assign`` and ``assign_multi`` whose kernel carries a
#: complex value, (re, im) pairs (not of their plain versions)
assign_complex = _Launches()


def assign_multi(exprs: Sequence[Expr], analysis: Analysis, types, leaves,
                 outs: Sequence[torch.Tensor], keyed=None) -> None:
    """Write the elementwise ``exprs[i]`` into ``outs[i]`` (1-D,
    contiguous, one length and one device) in one launch; ``keyed`` is
    ``launch_key``'s result where the caller keeps it."""
    device = outs[0].device
    if device.type == "cpu":
        assign_multi_plain(exprs, analysis, types, leaves, outs)
        return
    if device.type != "cuda":
        raise NotImplementedError(f"no expression kernel for {device}")
    if outs[0].numel() == 0:
        return
    if _launch(exprs, analysis, types, leaves, outs, keyed).complex:
        assign_complex.launches += 1
    else:
        assign_multi.launches += 1


#: launches of the k-output kernel that carry no complex value (not of its
#: plain version)
assign_multi.launches = 0


# ---------------------------------------------------------------------------
# V3: assignment through a view
# ---------------------------------------------------------------------------

#: how V3 writes a value at its index: a plain store (``=``, and the
#: read-modify-write of a compound op whose old value the tree gathers),
#: an atomic add, min or max, or an atomic multiply by compare-and-swap
TARGET_MODES = ("store", "add", "min", "max", "mul")

_ATOMIC_CODES = ("f32", "f64", "i32", "i64")
_BITS = {"f32": "tl.int32", "f64": "tl.int64", "i32": "tl.int32",
         "i64": "tl.int64"}


def assign_to_view_source(value: Expr, view: Expr, analysis: Analysis,
                          types: Dict[int, str], out_code: str,
                          mode: str) -> str:
    """The kernel writing ``value`` (evaluated at the element's index,
    over the view's length) into output ``o0`` at the index ``view``
    computes into the vector it views, lanes the view drops masked."""
    if out_code in COMPLEX_CODES or any(
            isinstance(l, torch.Tensor) and l.dtype.is_complex
            for l in analysis.leaves):
        raise NotImplementedError(
            "complex values are not covered by the CUDA view-assignment "
            "kernel")
    if mode != "store" and out_code not in _ATOMIC_CODES:
        raise NotImplementedError(
            f"atomic {mode} into {dtype_of_code(out_code)} is not covered by "
            "the CUDA view-assignment kernel")
    em = Emitter(analysis, types)
    r = em.cast(em.value(value), types[id(value)], out_code)
    j, mj, _ = view.emit_index(em)
    src = [_HEADER,
           jit_header("assign_view_kernel", analysis, ["o0"],
                      ["n", "BLOCK: tl.constexpr"]),
           "    offs = tl.program_id(0).to(tl.int64) * BLOCK "
           "+ tl.arange(0, BLOCK)\n",
           "    mask = offs < n\n"]
    src += [f"    {line}\n" for line in em.lines]
    # tl.where broadcasts a leafless (scalar-only) value to the block
    src.append(f"    val = tl.where({mj}, {r}, {r})\n")
    if mode == "store":
        src.append(f"    tl.store(o0 + {j}, val, mask={mj})\n")
    elif mode != "mul":
        src.append(f"    tl.atomic_{mode}(o0 + {j}, val, mask={mj}, "
                   "sem='relaxed')\n")
    else:
        # no atomic multiply: compare-and-swap on the bits until every
        # lane's product lands; lanes done or masked swap a value for
        # itself, which changes nothing
        it, ft = _BITS[out_code], tl_type(out_code)
        src += [f"    ptr = (o0 + {j}).to(tl.pointer_type({it}))\n",
                f"    cur = tl.load(o0 + {j}, mask={mj}, other=0)\n",
                f"    pend = {mj}\n",
                "    while tl.max(pend.to(tl.int32), axis=0) > 0:\n",
                "        new = tl.where(pend, cur * val, cur)\n",
                f"        seen = tl.atomic_cas(ptr, cur.to({it}, bitcast=True), "
                f"new.to({it}, bitcast=True), sem='relaxed')\n",
                f"        pend = pend & (seen != cur.to({it}, bitcast=True))\n",
                f"        cur = seen.to({ft}, bitcast=True)\n"]
    return "".join(src)


def assign_to_view_plain(value: Expr, view: Expr, analysis: Analysis, types,
                         leaves, out: torch.Tensor, mode: str,
                         n: int) -> None:
    """The kernel's plain PyTorch version: every value first, then
    ``index_put_``, ``index_add_`` or ``scatter_reduce_``."""
    env = EmitEnv({nid: leaves[s] for nid, s in analysis.slot_of.items()},
                  types, n, out.device)
    val = torch.broadcast_to(value.emit_cached(env), (n,)).to(out.dtype)
    idx, valid = view.plain_index(env)
    idx = torch.broadcast_to(idx, (n,))
    if valid is not None:
        valid = torch.broadcast_to(valid, (n,))
        idx, val = idx[valid], val[valid]
    if mode == "store":
        out.index_put_((idx,), val.clone())
    elif mode == "add":
        out.index_add_(0, idx, val)
    else:
        out.scatter_reduce_(0, idx, val, {"min": "amin", "max": "amax",
                                          "mul": "prod"}[mode])


_HOST_SCALAR_NODES = (ScalarTerminal, ConstantTerminal, CastExpr, UnOp,
                      BinOp)


def _host_scalar(value: Expr, analysis: Analysis, types, leaves,
                 dtype: torch.dtype):
    """``value`` as a numpy scalar of ``dtype`` where it is computed from
    host numbers alone (scalars, constants, casts and arithmetic), as its
    plain version computes it; else None.  A cast of one Python or numpy
    number is cast by numpy (as ``Tensor.to`` casts), the rest evaluated
    by the plain version on the CPU."""
    np_type = cuda_scatter.NP_TYPES.get(dtype)
    if np_type is None:
        return None
    if isinstance(value, CastExpr) and value.dtype == dtype \
            and isinstance(value.children[0], ScalarTerminal):
        v = leaves[analysis.slot_of[id(value.children[0])]]
        if isinstance(v, (int, float, np.integer, np.floating)) \
                and not isinstance(v, bool):
            return convert(torch.from_numpy(np.asarray(v)),
                           code_of(dtype)).numpy()[()]
    stack = [value]
    while stack:
        e = stack.pop()
        if not isinstance(e, _HOST_SCALAR_NODES) or (
                isinstance(e, ScalarTerminal) and isinstance(
                    leaves[analysis.slot_of[id(e)]], torch.Tensor)):
            return None
        stack.extend(e.children)
    env = EmitEnv({nid: leaves[s] for nid, s in analysis.slot_of.items()},
                  types, 1, torch.device("cpu"))
    return convert(torch.as_tensor(value.emit_cached(env)),
                   code_of(dtype)).numpy()[()]


def _leaf_tensor(node: Expr, analysis: Analysis, leaves, n: int, dtypes,
                 device: torch.device):
    """The tensor of a leaf (a vector, an array, a kernel's bound
    parameter) of n elements of one of ``dtypes`` on ``device``, or
    None."""
    if node.children or id(node) not in analysis.slot_of:
        return None
    t = leaves[analysis.slot_of[id(node)]]
    if isinstance(t, torch.Tensor) and t.ndim == 1 and t.shape[0] == n \
            and t.dtype in dtypes and t.device == device \
            and t.is_contiguous():
        return t
    return None


def _scatter_operands(value: Expr, view: Expr, analysis: Analysis, types,
                      leaves, out: torch.Tensor, mode: str, n: int):
    """(form, index, values or None, scalar or None) where
    ``cuda_scatter.route`` sends the assignment to a CUDA kernel, else
    None.  A leaf index of i32 or i64 and a leaf value of the target's
    type are read as they are; otherwise one K1 launch evaluates the i32
    index and the cast value into temporaries.  An index that shares the
    target's memory is copied first (the kernels write the target while
    other blocks still read the index)."""
    from .view import PermutationView

    if not isinstance(view, PermutationView):
        return None
    scalar = _host_scalar(value, analysis, types, leaves, out.dtype) \
        if mode in cuda_scatter.ROUTE_MODES else None
    form = cuda_scatter.route(mode, out.dtype, out.numel(), n)
    if form is None:
        return None
    inner = view.children[1]
    idx = _leaf_tensor(inner, analysis, leaves, n,
                       (torch.int32, torch.int64), out.device)
    val = None
    if scalar is None and isinstance(value, CastExpr) \
            and value.dtype == out.dtype:
        val = _leaf_tensor(value.children[0], analysis, leaves, n,
                           (out.dtype,), out.device)
    need = ([CastExpr(torch.int32, inner)] if idx is None else []) + (
        [value] if scalar is None and val is None else [])
    if need:
        from .compile import evaluate_multi

        got = list(evaluate_multi(need, n=n, device=out.device))
        idx = got.pop(0) if idx is None else idx
        val = got.pop(0) if scalar is None and val is None else val
    if idx.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
        idx = idx.clone()
    return form, idx, val, scalar


def assign_to_view(value: Expr, view: Expr, analysis: Analysis, types,
                   leaves, out: torch.Tensor, mode: str, n: int) -> None:
    """Write the elementwise ``value`` over n elements through ``view``
    into ``out``, the storage of the vector it views, by ``mode``
    (``TARGET_MODES``): where ``cuda_scatter.route`` sends the assignment
    to a CUDA kernel (a permutation target), through it (its inputs read
    as they are, or evaluated by one K1 launch first), else in one launch
    of the view-assignment kernel."""
    if mode not in TARGET_MODES:
        raise ValueError(f"unknown view-assignment mode {mode!r}")
    if out.device.type == "cpu":
        assign_to_view_plain(value, view, analysis, types, leaves, out, mode,
                             n)
        return
    if out.device.type != "cuda":
        raise NotImplementedError(f"no view-assignment kernel for "
                                  f"{out.device}")
    if n == 0 or out.numel() == 0:
        return
    ops = _scatter_operands(value, view, analysis, types, leaves, out, mode,
                            n)
    if ops is not None:
        form, idx, val, scalar = ops
        cuda_scatter.FORMS[form](out, idx, val, mode, scalar)
        return
    # the view's structure: its index children are roots of the analysis,
    # the view itself is not
    key = ("assign_view", mode, type(view).__name__,
           view.extra_sig()) + kernel_key(analysis, (out.dtype,))

    def factory():
        return _AssignKernel(assign_to_view_source(
            value, view, analysis, types, code_of(out.dtype), mode),
            "assign_view_kernel")

    k = (kernel_cache.get_or_create(key, factory) if config.cache_kernels
         else factory())
    k.launch([out], leaves, n)
    assign_to_view.launches += 1


#: launches of the view-assignment kernel (V3's Triton kernel; not of its
#: plain version, nor of the CUDA scatter kernels)
assign_to_view.launches = 0
