"""Lazy expression tree — the expression engine core.

Port of ``vexcl_tpu/expr/node.py`` (vexcl/operations.hpp: grammars
:682-827, ``vector_expr_context`` :1196-1353).  The tree, its operator
overloads, ``analyze()`` and the structural signature strings are the JAX
package's, unchanged: one deterministic preorder walk gives the signature,
the deduplicated leaf list and the elementwise sizes.

Every node implements:

* ``children``      — sub-expressions,
* ``extra_sig()``   — static parameters baked into the signature,
* ``leaf_key()`` / ``payload()`` — (terminals) dedup identity and runtime
  argument,
* ``infer(types)``  — its result type as a lattice code (``types.py``),
  following the JAX package's promotion,
* ``emit(env)``     — the plain PyTorch value, used for CPU tensors,
* ``emit_src(em)``  — the emitter hook: appends this node's lines to the
  Triton kernel source being generated (``triton_emit.py``) and returns
  the name of the variable that holds its value (a complex value: the
  pair of names of its real and imaginary parts).

What the JAX package needed only for XLA and the TPU is gone: no tracing,
no padded sharded storage, no placement or donation flags on the emit
environment.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import (COMPLEX_CODES, code_of, dtype_of, dtype_of_code, join,
                     real_code, scalar_code, to_float, to_inexact)

__all__ = [
    "Expr", "BinOp", "UnOp", "FuncCall", "Where", "VectorTerminal",
    "ArrayTerminal", "ScalarTerminal", "ConstantTerminal", "ElementIndex",
    "TaggedTerminal", "Temporary", "CastExpr", "element_index", "tag",
    "make_temp", "constant", "cast", "if_else", "as_expr", "EmitEnv",
    "Analysis", "analyze", "infer_types", "LazyTypes",
    "expression_properties", "convert", "int_edges",
]


def int_edges(dtype: torch.dtype) -> Tuple[float, float]:
    """(lo, top) of an integer type: its least value and the power of two
    above its largest, both exact in every float type that reaches them
    (a float at or beyond either saturates)."""
    info = torch.iinfo(dtype)
    return float(info.min), 2.0 ** (info.bits - (1 if info.min else 0))


def convert(t: torch.Tensor, code: str) -> torch.Tensor:
    """``t`` in type ``code`` as ``lax.convert_element_type`` converts it.
    A float (or a complex value's real part) becomes an integer by
    truncation toward zero, saturating: NaN gives 0, values at or beyond
    the type's range and infinities its least or largest value (0 for a
    negative value in an unsigned type).  The limits are compared before
    the conversion, in f64, where every float type and every edge is
    exact.  Everything else is ``Tensor.to``: integers wrap, a float or
    complex value becomes a boolean by ``x != 0``."""
    dt = dtype_of_code(code)
    if t.dtype == dt:
        return t
    if t.is_complex() and not dt.is_complex and dt != torch.bool:
        t = t.real                  # astype of a complex value to a real type
    if not t.dtype.is_floating_point or dt.is_floating_point \
            or dt.is_complex or dt == torch.bool:
        return t.to(dt)
    w = t.to(torch.float64)
    lo, top = int_edges(dt)
    high, low = w >= top, (w <= lo) | torch.isnan(w)
    # every value left converts exactly: |trunc(w)| < 2^63, or (u64)
    # w - 2^63 does
    safe = torch.where(high | low, 0.0, w)
    if dt == torch.uint64:
        big = safe >= 2.0 ** 63
        v = torch.where(big, safe - 2.0 ** 63, safe).to(torch.int64)
        v = torch.where(big, v ^ _I64_MIN, v)
        return torch.where(high, -1, v).view(torch.uint64)
    info = torch.iinfo(dt)
    v = torch.where(high, info.max, safe.to(torch.int64))
    # NaN gives 0: the least value only where w is not NaN
    v = torch.where(low & ~torch.isnan(w), info.min, v)
    return v.to(dt)


class EmitEnv:
    """Leaf values and output size for the plain PyTorch evaluation.

    ``leaves`` maps id(terminal) -> its payload (tensor or scalar);
    ``values`` memoizes each node's tensor; ``types`` maps id(node) ->
    lattice code; ``n`` is the output length; ``device`` places scalars
    and the element index."""

    def __init__(self, leaves: Dict[int, Any], types: Dict[int, str],
                 n: Optional[int], device: torch.device):
        self.leaves = leaves
        self.values: Dict[int, Any] = {}
        self.types = types
        self.n = n
        self.device = device
        self.temps: Dict[Any, Any] = {}

    def cast(self, node: "Expr", code: str) -> torch.Tensor:
        return convert(node.emit_cached(self), code)

    def leaf(self, node: "Expr") -> torch.Tensor:
        """A leaf's value as a tensor: a scalar payload (a Python number,
        or a 0-d CPU tensor that crossed into a CUDA evaluation as a numpy
        scalar) becomes a 0-d tensor of the leaf's type."""
        v = self.leaves[id(node)]
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, np.generic):
            return torch.from_numpy(np.asarray(v)).to(self.device)
        return torch.tensor(v, dtype=dtype_of_code(self.types[id(node)]),
                            device=self.device)


class Analysis:
    """Result of one structural traversal: cache signature + flat leaves."""

    __slots__ = ("sig", "leaves", "slot_of", "elementwise_sizes", "indexed",
                 "index_bits", "gathered", "hoist")

    def __init__(self, sig: str, leaves: List[Any], slot_of: Dict[int, int],
                 elementwise_sizes: List[int] = (), indexed: bool = False,
                 hoist: bool = False):
        self.sig = sig
        self.leaves = leaves
        self.slot_of = slot_of
        self.elementwise_sizes = elementwise_sizes
        #: True when a view reads a subtree at computed indices (V1)
        self.indexed = indexed
        #: True when a node runs its own kernel first (``compile.hoist``)
        self.hoist = hoist
        #: width of the kernel's index arithmetic, 32 or 64 bits, and the
        #: slots read beneath a view: set by ``compile.prepare_multi`` from
        #: the sizes the views reach
        self.index_bits = 64
        self.gathered: frozenset = frozenset()


class _SigCtx:
    def __init__(self) -> None:
        self.leaves: List[Any] = []
        self.slot_of: Dict[int, int] = {}
        self._key_slot: Dict[Any, int] = {}
        # shared subtrees get a back-reference "@k" and are walked once
        self.node_ref: Dict[int, int] = {}
        # sizes of vector terminals reached only through size-preserving
        # nodes (the VEXCL_CHECK_SIZES walk, operations.hpp:1442-1458)
        self.elementwise_sizes: List[int] = []
        self.transparent: bool = True
        self.seen_transparent: set = set()
        # a view node was walked: the kernel computes indices
        self.indexed: bool = False
        # a node that runs its own kernel first was walked
        self.hoist: bool = False

    def slot(self, node: "Expr") -> int:
        key = node.leaf_key()
        s = self._key_slot.get(key)
        if s is None:
            s = self._key_slot[key] = len(self.leaves)
            self.leaves.append(node.payload())
        self.slot_of[id(node)] = s
        return s


def analyze(*exprs: "Expr") -> Analysis:
    """One deterministic preorder traversal over (possibly several) DAGs;
    ``Analysis.hoist`` tells whether it met a node that runs its own
    kernel first (the trees are then to be hoisted and analysed again)."""
    ctx = _SigCtx()
    sigs = [e.sig_cached(ctx) for e in exprs]
    return Analysis(";".join(sigs), ctx.leaves, ctx.slot_of,
                    ctx.elementwise_sizes, ctx.indexed, ctx.hoist)


def infer_types(*exprs: "Expr") -> Dict[int, str]:
    """Lattice code of every node, keyed by id(node)."""
    types: Dict[int, str] = {}
    for e in exprs:
        e.infer(types)
    return types


class LazyTypes(dict):
    """``infer_types`` of some trees, taken at the first lookup of a
    missing node: a launch whose kernel is built already reads no type,
    so the types cost nothing on that path."""

    def __init__(self, *exprs: "Expr"):
        super().__init__()
        self._exprs = exprs

    def __missing__(self, key: int) -> str:
        exprs, self._exprs = self._exprs, ()
        for e in exprs:
            e.infer(self)
        if key in self:
            return dict.__getitem__(self, key)
        raise KeyError(key)


class Expr:
    """Base class: lazy value with operator overloads."""

    children: Tuple["Expr", ...] = ()
    _opname = "expr"
    #: False on size-transforming nodes (the SpMV): vector terminals
    #: beneath them are exempt from elementwise size checks.
    _size_transparent = True
    #: False on nodes that read other indices than their own (the SpMV).
    #: Evaluation computes them first into a temporary (``hoist``), so the
    #: elementwise kernel never reads an index it does not write.
    _elementwise = True
    #: a method on nodes that can write their value straight into a
    #: target (``compile.evaluate``): the value's type, or None
    direct_dtype = None
    #: (BLOCK, warps) that an assignment kernel over this node launches
    #: with (``triton_emit.launch_shape``), or None for the default
    kernel_shape: Optional[Tuple[int, int]] = None

    # -- structural signature ---------------------------------------------
    def extra_sig(self) -> str:
        return ""

    def sig_cached(self, ctx: _SigCtx) -> str:
        nid = id(self)
        ref = ctx.node_ref.get(nid)
        if ref is not None:
            if ctx.transparent and nid not in ctx.seen_transparent:
                self._collect_sizes(ctx)
            return f"@{ref}"
        ctx.node_ref[nid] = len(ctx.node_ref)
        if ctx.transparent:
            ctx.seen_transparent.add(nid)
        if not self._elementwise:
            ctx.hoist = True
        return self._sig(ctx)

    def _collect_sizes(self, ctx: _SigCtx) -> None:
        ctx.seen_transparent.add(id(self))
        if not self._size_transparent:
            return
        for c in self.children:
            if id(c) not in ctx.seen_transparent:
                c._collect_sizes(ctx)

    def _sig(self, ctx: _SigCtx) -> str:
        if self._size_transparent or not ctx.transparent:
            inner = ",".join([c.sig_cached(ctx) for c in self.children])
        else:
            ctx.transparent = False
            inner = ",".join([c.sig_cached(ctx) for c in self.children])
            ctx.transparent = True
        ex = self.extra_sig()
        return f"{self._opname}{'[' + ex + ']' if ex else ''}({inner})"

    # -- terminals override these ------------------------------------------
    def leaf_key(self) -> Any:
        raise NotImplementedError

    def payload(self) -> Any:
        raise NotImplementedError

    # -- types ----------------------------------------------------------------
    def infer(self, types: Dict[int, str]) -> str:
        nid = id(self)
        code = types.get(nid)
        if code is None:
            code = self._infer([c.infer(types) for c in self.children])
            types[nid] = code
        return code

    def _infer(self, child_codes: List[str]) -> str:
        raise NotImplementedError

    # -- evaluation -----------------------------------------------------------
    def emit_cached(self, env: EmitEnv):
        """Plain PyTorch value, memoized per node (DAG-safe)."""
        vid = id(self)
        if vid in env.values:
            return env.values[vid]
        v = self.emit(env)
        env.values[vid] = v
        return v

    def emit(self, env: EmitEnv):
        raise NotImplementedError

    def emit_src(self, em) -> str:
        raise NotImplementedError(
            f"{type(self).__name__} has no kernel form on CUDA")

    def with_children(self, children: Sequence["Expr"]) -> "Expr":
        out = copy.copy(self)
        out.children = tuple(children)
        return out

    # -- size inference (get_expression_properties analog) --------------------
    def child_sizes(self, m: Optional[int]) -> List[Optional[int]]:
        """The number of elements each child is evaluated over when this
        node is evaluated over m: m for every child, except beneath a view,
        which reads its inner expression over the inner's own length."""
        return [m] * len(self.children)

    def size_hint(self) -> Optional[int]:
        for c in self.children:
            n = c.size_hint()
            if n is not None:
                return n
        return None

    def vector_terminals(self, sized_only: bool = False
                         ) -> List["VectorTerminal"]:
        """The vector leaves; with ``sized_only``, only those reached
        through size-preserving nodes (not beneath an SpMV)."""
        out: List[VectorTerminal] = []
        stack: List[Expr] = [self]
        seen = set()
        while stack:
            e = stack.pop()
            if id(e) in seen:
                continue
            seen.add(id(e))
            if isinstance(e, VectorTerminal):
                out.append(e)
            if e._size_transparent or not sized_only:
                stack.extend(e.children)
        return out

    # -- python protocol ----------------------------------------------------
    def __add__(self, o):
        return BinOp("add", self, as_expr(o))

    def __radd__(self, o):
        return BinOp("add", as_expr(o), self)

    def __sub__(self, o):
        return BinOp("sub", self, as_expr(o))

    def __rsub__(self, o):
        return BinOp("sub", as_expr(o), self)

    def __mul__(self, o):
        return BinOp("mul", self, as_expr(o))

    def __rmul__(self, o):
        return BinOp("mul", as_expr(o), self)

    def __truediv__(self, o):
        return BinOp("div", self, as_expr(o))

    def __rtruediv__(self, o):
        return BinOp("div", as_expr(o), self)

    def __floordiv__(self, o):
        return BinOp("floordiv", self, as_expr(o))

    def __rfloordiv__(self, o):
        return BinOp("floordiv", as_expr(o), self)

    def __mod__(self, o):
        return BinOp("mod", self, as_expr(o))

    def __rmod__(self, o):
        return BinOp("mod", as_expr(o), self)

    def __pow__(self, o):
        return BinOp("pow", self, as_expr(o))

    def __rpow__(self, o):
        return BinOp("pow", as_expr(o), self)

    def __neg__(self):
        return UnOp("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return UnOp("abs", self)

    def __invert__(self):
        return UnOp("bitnot", self)

    def __and__(self, o):
        return BinOp("bitand", self, as_expr(o))

    def __rand__(self, o):
        return BinOp("bitand", as_expr(o), self)

    def __or__(self, o):
        return BinOp("bitor", self, as_expr(o))

    def __ror__(self, o):
        return BinOp("bitor", as_expr(o), self)

    def __xor__(self, o):
        return BinOp("bitxor", self, as_expr(o))

    def __rxor__(self, o):
        return BinOp("bitxor", as_expr(o), self)

    def __lshift__(self, o):
        return BinOp("shl", self, as_expr(o))

    def __rshift__(self, o):
        return BinOp("shr", self, as_expr(o))

    def __lt__(self, o):
        return BinOp("lt", self, as_expr(o))

    def __le__(self, o):
        return BinOp("le", self, as_expr(o))

    def __gt__(self, o):
        return BinOp("gt", self, as_expr(o))

    def __ge__(self, o):
        return BinOp("ge", self, as_expr(o))

    def __eq__(self, o):  # noqa: E721 - expression semantics, like VexCL
        return BinOp("eq", self, as_expr(o))

    def __ne__(self, o):
        return BinOp("ne", self, as_expr(o))

    __hash__ = None  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# Operators.  Each entry: (result-type rule, PyTorch form, kernel form).
# Result types follow jnp: "join" = promoted type of the operands,
# "numeric" = the same, with booleans computed as i32 (jnp's
# ``promote_args_numeric``: ``b // b``, ``b % b``, ``b << b`` are i32),
# "inexact" = promoted and then made floating (i32 / i32 -> f32),
# "float" = promoted, an integer or boolean type cast to the default float
# type (``jnp.rint``: i32 -> f64), "weak_inexact" = promoted with a weak
# float (the jnp forms that scale by a Python float, ``jnp.sin(pi * x)``:
# i32 -> weak f64, f32 -> f32), "join_real" = "join" of real types only
# (``jnp.ceil`` of a complex value raises TypeError),
# "bool" = comparisons, "real" = promoted, the result the type of a complex
# value's parts (``jnp.abs``, ``jnp.real``: c64 -> f32).  The PyTorch and
# kernel forms receive operands already cast to the compute type (the
# promoted operand type; ``_arg_codes`` names the few operands cast to
# another).  The builtin catalog adds rules of a few entries each
# (``builtins.py``).
# ---------------------------------------------------------------------------


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, 0 or 1 by the sign, NaN at NaN and a zero kept
    with its sign (``torch.sign`` gives 0 at NaN and +0.0 at -0.0); of a
    complex value x/|x|, part by part (inf + 0j gives NaN + 0j, as XLA's
    sign), and 0 at 0."""
    if x.is_complex():
        a = torch.abs(x)
        s = torch.complex(x.real / a, x.imag / a)
        return torch.where(a == 0, torch.zeros_like(x), s)
    if x.dtype == torch.bool:
        raise TypeError("sign does not accept booleans")
    if not x.dtype.is_floating_point:
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _float_divmod(a, b):
    """jnp's float floor_divide/remainder (jax/_src/numpy/ufuncs.py
    ``_float_divmod``): fmod-based, quotient rounded half away from 0."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (sign(b) != sign(mod))
    mod = torch.where(ind, mod + b, mod)
    div = torch.where(ind, div - 1, div)
    return sign(div) * torch.floor(torch.abs(div) + 0.5), mod


def _lax_divrem(a, b):
    """XLA's truncating integer quotient and remainder (``lax.div``,
    ``lax.rem``), which PyTorch's CPU kernels raise (a zero divisor) or
    trap (the least signed integer by -1) on: a zero divisor gives all
    ones (-1, or the largest unsigned value) and the dividend; a divisor
    of -1 the wrapped negation and 0."""
    zero = b == 0
    minus = (b == -1) if b.dtype.is_signed else torch.zeros_like(zero)
    bs = torch.where(zero | minus, torch.ones_like(b), b)
    q = torch.where(minus, -a, torch.div(a, bs, rounding_mode="trunc"))
    q = torch.where(zero, ~torch.zeros_like(q), q)
    return q, torch.where(zero, a, torch.fmod(a, bs))


def _floordiv(a, b):
    """``jnp.floor_divide``: lax.div, one less where the signs differ and
    the division is not exact (so x // 0 is -2, or -1 for x == 0)."""
    if a.dtype.is_floating_point:
        return _float_divmod(a, b)[0]
    q, r = _lax_divrem(a, b)
    if not a.dtype.is_signed:
        return q
    return q - ((torch.sign(a) != torch.sign(b)) & (r != 0)).to(q.dtype)


def _mod(a, b):
    """``jnp.remainder``: a zero divisor taken as 1 (x % 0 is 0), the
    remainder given the divisor's sign."""
    if a.dtype.is_floating_point:
        return _float_divmod(a, b)[1]
    b = torch.where(b == 0, torch.ones_like(b), b)
    r = _lax_divrem(a, b)[1]
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def fmod(a, b):
    """``jnp.fmod`` of operands in an integer or float compute type: an
    integer zero divisor taken as 1 (fmod(x, 0) is 0).  Booleans, whose
    zero divisor jnp leaves (``lax.rem(x, 0)`` is x), are ``fmod_bool``."""
    if a.dtype.is_floating_point:
        return torch.fmod(a, b)
    return _lax_divrem(a, torch.where(b == 0, torch.ones_like(b), b))[1]


def fmod_bool(a, b):
    """``jnp.fmod`` of two booleans, computed in i32: jnp replaces a zero
    divisor only for integer types, so fmod(x, False) is x."""
    return torch.where(b != 0, torch.zeros_like(a), a)


_BINOPS: Dict[str, Tuple[str, Any, Optional[str]]] = {
    "add": ("join", torch.add, "({0} + {1})"),
    "sub": ("join", torch.sub, "({0} - {1})"),
    "mul": ("join", torch.mul, "({0} * {1})"),
    "div": ("inexact", torch.div, "libdevice.div_rn({0}, {1})"),
    "floordiv": ("numeric", _floordiv, "floordiv"),
    "mod": ("numeric", _mod, "mod"),
    "pow": ("numeric", torch.pow, "pow"),
    "bitand": ("join", torch.bitwise_and, "({0} & {1})"),
    "bitor": ("join", torch.bitwise_or, "({0} | {1})"),
    "bitxor": ("join", torch.bitwise_xor, "({0} ^ {1})"),
    "shl": ("numeric", torch.bitwise_left_shift, "({0} << {1})"),
    "shr": ("numeric", torch.bitwise_right_shift, "({0} >> {1})"),
    "lt": ("bool", torch.lt, "({0} < {1})"),
    "le": ("bool", torch.le, "({0} <= {1})"),
    "gt": ("bool", torch.gt, "({0} > {1})"),
    "ge": ("bool", torch.ge, "({0} >= {1})"),
    "eq": ("bool", torch.eq, "({0} == {1})"),
    "ne": ("bool", torch.ne, "({0} != {1})"),
    "atan2": ("inexact", torch.atan2, "libdevice.atan2({0}, {1})"),
    "fmod": ("numeric", fmod, "fmod"),
    "min": ("join", torch.minimum, "min"),
    "max": ("join", torch.maximum, "max"),
    "hypot": ("inexact", torch.hypot, "libdevice.hypot({0}, {1})"),
    "copysign": ("inexact", torch.copysign, "libdevice.copysign({0}, {1})"),
    "fdim": ("join", lambda a, b: torch.maximum(a - b, torch.zeros_like(a)),
             "max0"),
    "logical_and": ("bool", torch.logical_and, "(({0} != 0) & ({1} != 0))"),
    "logical_or": ("bool", torch.logical_or, "(({0} != 0) | ({1} != 0))"),
}

_UNOPS: Dict[str, Tuple[str, Any, Optional[str]]] = {
    "neg": ("same", torch.neg, "(-{0})"),
    "abs": ("real", torch.abs, "tl.abs({0})"),
    "bitnot": ("same", torch.bitwise_not, "(~{0})"),
    "logical_not": ("bool", torch.logical_not, "({0} == 0)"),
}


_INT_WIDTH = {"u8": 8, "i8": 8, "u16": 16, "i16": 16, "u32": 32, "i32": 32,
              "u64": 64, "i64": 64, "i*": 64}


def _integer(code: str, what: str) -> str:
    if code not in _INT_WIDTH:
        raise TypeError(f"{what} takes integer operands, not "
                        f"{dtype_of_code(code)}")
    return code


def _result_code(rule: str, codes: List[str]) -> Tuple[str, str]:
    """(compute code, result code) of an operator under ``rule``."""
    if rule == "select":
        # jnp.where(c, b, a): the condition is not promoted with a and b
        codes = codes[:2]
    c = codes[0]
    for o in codes[1:]:
        c = join(c, o)
    if rule == "inexact":
        c = to_inexact(c)
        return c, c
    if rule == "join_inexact":
        # operands in their promoted type, the result inexact
        return c, to_inexact(c)
    if rule == "float":
        c = to_float(c)
        return c, c
    if rule in ("weak_inexact", "gamma_sign"):
        c = join(c, "f*")
        return c, "i*" if rule == "gamma_sign" else c
    if rule in ("join_real", "msb", "ilogb", "ldexp") and \
            c in COMPLEX_CODES:
        raise TypeError(f"no {dtype_of_code(c)} operand is accepted here "
                        "(integer and float types only)")
    if rule == "bool":
        return c, "b1"
    if rule == "real":
        return c, real_code(c)
    if rule == "numeric" and c == "b1":
        return "i32", "i32"
    if rule == "int":
        return _integer(c, "this builtin"), c
    if rule == "int_numeric":
        c = "i32" if c == "b1" else _integer(c, "rotate")
        return c, c
    if rule == "step":
        # jnp.where(x < edge, 0.0, 1.0).astype(result_type(x))
        return c, codes[-1]
    if rule == "msb":
        return codes[0], "i32"
    if rule == "ilogb":
        return to_inexact(codes[0]), "i32"
    if rule == "nan":
        return codes[0], "f32"
    if rule == "ldexp":
        if codes[1] not in _INT_WIDTH and codes[1] != "b1":
            raise TypeError("ldexp takes an integer exponent, not "
                            f"{dtype_of_code(codes[1])}")
        c = to_inexact(codes[0])
        return c, c
    if rule == "upsample":
        hi = codes[0]
        if _INT_WIDTH.get(hi, 64) == 64 or codes[1] not in _INT_WIDTH:
            raise TypeError("upsample takes 8-, 16- or 32-bit integers")
        wide = {8: "16", 16: "32", 32: "64"}[_INT_WIDTH[hi]]
        return hi, hi[0] + wide
    return c, c


def _arg_codes(rule: str, codes: List[str], cc: str) -> List[str]:
    """The code each operand is cast to before the operator's forms see
    it: the compute code, except the condition of ``select`` (a boolean),
    the exponent of ``ldexp`` (i64) and the low half of ``upsample`` (the
    unsigned type of the high half's width)."""
    if rule == "select":
        return [cc, cc, "b1"]
    if rule == "ldexp":
        return [cc, "i64"]
    if rule == "upsample":
        return [cc, "u" + cc[1:]]
    return [cc] * len(codes)


# ---------------------------------------------------------------------------
# Unsigned arithmetic in the plain forms.  PyTorch's CPU kernels lack most
# operations on u16, u32 and u64 (add, compares, min/max, shifts, ...), so
# the plain forms compute them in a signed carrier and wrap the result
# back, as ``ops/random.py`` carries u32 words in int64: u16 in i32 and
# u32 in i64, where every operation the catalog has is right on the
# carried value once wrapped; u64 in i64 two's complement, where add,
# sub, mul, neg, the bitwise operations and ``<<`` are right bit for bit
# and the rest needs unsigned semantics by hand: order by the sign bit
# flipped, an unsigned divide, a logical ``>>``.
# ---------------------------------------------------------------------------

_CARRIER = {"u16": (torch.int32, 0xFFFF), "u32": (torch.int64, 0xFFFFFFFF),
            "u64": (torch.int64, None)}
_I64_MIN = -(1 << 63)
#: operations that compare (or select by comparing) their operands
_ORDERED = {"lt", "le", "gt", "ge", "isless", "islessequal", "isgreater",
            "isgreaterequal", "min", "max", "fmin", "fmax", "clamp"}


def _lshr64(a: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of i64 words by s (0-63, or a tensor of them)."""
    s = torch.as_tensor(s, dtype=torch.int64, device=a.device)
    # shift by one logically, then arithmetically by the rest: no sign
    # bit is left to extend
    once = torch.bitwise_right_shift(a, 1) & ((1 << 63) - 1)
    return torch.where(s == 0, a, torch.bitwise_right_shift(
        once, torch.clamp(s - 1, min=0)))


def _ult64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _udivmod64(a: torch.Tensor, b: torch.Tensor):
    """Unsigned quotient and remainder of u64 words carried in i64."""
    a, b = torch.broadcast_tensors(a, b)
    big = b < 0                       # a divisor of 2^63 or more
    bp = torch.where(big | (b == 0), 1, b)
    # (a >> 1) // b fits a signed divide; the quotient is that doubled, or
    # doubled plus one, as the remainder left says
    q = torch.div(_lshr64(a, 1), bp, rounding_mode="trunc") << 1
    r = a - q * bp
    more = ~_ult64(r, bp)
    q = torch.where(more, q + 1, q)
    r = torch.where(more, r - bp, r)
    ge = ~_ult64(a, b)
    q = torch.where(big, ge.to(torch.int64), q)
    r = torch.where(big, torch.where(ge, a - b, a), r)
    return q, r


def _u64_form(op: str, fn, args: List[torch.Tensor]) -> torch.Tensor:
    """``fn`` of u64 words carried in i64, with unsigned semantics."""
    if op in _ORDERED:
        out = fn(*[a ^ _I64_MIN for a in args])
        return out if out.dtype == torch.bool else out ^ _I64_MIN
    if op in ("floordiv", "mod", "fmod"):
        q, r = _udivmod64(*args)
        if op != "floordiv":
            return r
        # XLA: a zero divisor gives all ones
        return torch.where(args[1] == 0, -1, q)
    if op == "shr":
        return _lshr64(*args)
    if op == "signbit":
        return torch.zeros_like(args[0], dtype=torch.bool)
    if op in ("abs", "fabs"):
        return args[0]
    if op == "sign":
        return (args[0] != 0).to(torch.int64)
    if op in ("fdim", "abs_diff"):
        # jnp: max(a - b, 0) and |a - b| of the wrapped difference, which
        # is never below 0
        return args[0] - args[1]
    if op in ("hadd", "rhadd"):
        a, b = args
        half = _lshr64(a ^ b, 1)
        return (a & b) + half if op == "hadd" else (a | b) - half
    return fn(*args)


def _carried(op: str, fn, args: List[torch.Tensor], cc: str,
             out: torch.dtype, cond=None) -> torch.Tensor:
    """``fn`` over operands of the unsigned compute type ``cc`` (already
    cast to it), computed in its carrier and wrapped back to ``out``;
    ``where`` takes its condition as ``cond``."""
    carrier, mask = _CARRIER[cc]
    if mask is None:
        vals = [a.view(torch.int64) for a in args]
        r = (torch.where(cond, *vals) if cond is not None
             else _u64_form(op, fn, vals))
        return r if r.dtype == torch.bool else r.view(torch.uint64).to(out)
    vals = [a.to(carrier) for a in args]
    if cond is not None:
        r = torch.where(cond, *vals)
    elif op in ("fdim", "abs_diff"):
        r = vals[0] - vals[1]
    elif op == "floordiv":
        r = _lax_divrem(*vals)[0]       # unsigned: no sign to adjust by
    else:
        r = fn(*vals)
    return r.to(out) if r.dtype == torch.bool else (r & mask).to(out)


def plain_apply(op: str, entry, vals: List[torch.Tensor],
                codes: List[str]) -> torch.Tensor:
    """The PyTorch form of ``entry`` (a catalog or operator entry) over
    ``vals`` of type ``codes``: each operand cast to its compute type
    (``_arg_codes``), the result in the rule's result type.  A form
    marked ``typed`` takes the operands' codes and the result code first
    and handles unsigned types itself."""
    rule, fn = entry[0], entry[1]
    cc, rc = _result_code(rule, codes)
    acs = _arg_codes(rule, codes, cc)
    args = [convert(v, c) for v, c in zip(vals, acs)]
    out = dtype_of_code(rc)
    if getattr(fn, "typed", False):
        return fn(acs, rc, *args)
    if op == "fmod" and all(c == "b1" for c in codes):
        return fmod_bool(*args).to(out)
    if cc in _CARRIER:
        return _carried(op, fn, args, cc, out)
    if cc == "b1" and op in ("abs", "fabs"):
        return args[0]                  # jnp.abs of booleans
    return fn(*args).to(out)


class _Op(Expr):
    """Shared body of operator and builtin-call nodes."""

    _table: Dict[str, Tuple[str, Any, Optional[str]]] = {}

    def _entry(self):
        return self._table[self.op]

    def _infer(self, child_codes):
        return _result_code(self._entry()[0], child_codes)[1]

    def _codes(self, types):
        """(each operand's compute code, the compute code, the result
        code)."""
        rule = self._entry()[0]
        codes = [types[id(c)] for c in self.children]
        cc, rc = _result_code(rule, codes)
        return _arg_codes(rule, codes, cc), cc, rc

    def emit(self, env: EmitEnv):
        return plain_apply(self.op, self._entry(),
                           [c.emit_cached(env) for c in self.children],
                           [env.types[id(c)] for c in self.children])

    def emit_src(self, em) -> str:
        acs, cc, rc = self._codes(em.types)
        if cc == "b1" and self.op in ("abs", "fabs"):
            return em.value(self.children[0])     # jnp.abs of booleans
        fmod_bool = self.op == "fmod" and all(
            em.types[id(c)] == "b1" for c in self.children)
        form = "fmod_bool" if fmod_bool else self._entry()[2]
        args = [em.cast(em.value(c), em.types[id(c)], a)
                for c, a in zip(self.children, acs)]
        if cc in COMPLEX_CODES:
            # (re, im) pairs: the emitter's complex forms, or it raises
            return em.complex_op(self.op, args, cc)
        return em.define(em.apply(form, args, cc, self.op, rc))


class BinOp(_Op):
    _opname = "b"
    _table = _BINOPS

    def __init__(self, op: str, a: Expr, b: Expr):
        self.op = op
        self.children = (a, b)

    def extra_sig(self) -> str:
        return self.op


class UnOp(_Op):
    _opname = "u"
    _table = _UNOPS

    def __init__(self, op: str, a: Expr):
        self.op = op
        self.children = (a,)

    def extra_sig(self) -> str:
        return self.op


class FuncCall(_Op):
    """Application of a builtin device function (builtins.py).  Its
    catalog entry gives the result-type rule, the PyTorch form and the
    spelling in the kernel source."""

    _opname = "f"

    def __init__(self, name: str, entry, args: Sequence[Expr]):
        self.op = name
        self.entry = entry
        self.children = tuple(as_expr(a) for a in args)

    def _entry(self):
        return self.entry

    def extra_sig(self) -> str:
        return self.op


class Where(Expr):
    """Ternary select: if_else(cond, a, b) — `cond ? a : b`."""

    _opname = "where"

    def __init__(self, c: Expr, a: Expr, b: Expr):
        self.children = (as_expr(c), as_expr(a), as_expr(b))

    def _infer(self, child_codes):
        return join(child_codes[1], child_codes[2])

    def emit(self, env: EmitEnv):
        c, a, b = self.children
        code = env.types[id(self)]
        cond, av, bv = env.cast(c, "b1"), env.cast(a, code), env.cast(b, code)
        if code in _CARRIER:       # no unsigned where on the CPU
            return _carried("where", torch.where, [av, bv], code,
                            av.dtype, cond)
        return torch.where(cond, av, bv)

    def emit_src(self, em) -> str:
        c, a, b = self.children
        code = em.types[id(self)]
        cv = em.cast(em.value(c), em.types[id(c)], "b1")
        av = em.cast(em.value(a), em.types[id(a)], code)
        bv = em.cast(em.value(b), em.types[id(b)], code)
        return em.where(cv, av, bv)


class CastExpr(Expr):
    """vex::cast<T>(expr) (cast.hpp:44-120)."""

    _opname = "cast"

    def __init__(self, dtype, inner: Expr):
        self.dtype = dtype_of(dtype)
        self.children = (as_expr(inner),)

    def extra_sig(self) -> str:
        return str(self.dtype).replace("torch.", "")

    def _infer(self, child_codes):
        return code_of(self.dtype)

    def emit(self, env: EmitEnv):
        return env.cast(self.children[0], code_of(self.dtype))

    def emit_src(self, em) -> str:
        c = self.children[0]
        code = code_of(self.dtype)
        return em.bind(em.cast(em.value(c), em.types[id(c)], code))


# ---------------------------------------------------------------------------
# Terminals
# ---------------------------------------------------------------------------


class _ArrayLeaf(Expr):
    """Shared body of terminals whose payload is a 1-D tensor, or a 0-d
    one: a scalar of the tensor's (strong) type, broadcast."""

    def emit(self, env: EmitEnv):
        return env.leaf(self)

    def emit_src(self, em) -> str:
        return em.load(self)


class VectorTerminal(_ArrayLeaf):
    """A vector leaf — one kernel argument, deduplicated by storage
    identity (what vex::tag achieves by hand, tagged_terminal.hpp)."""

    _opname = "v"

    def __init__(self, vec):
        self.vec = vec

    def _collect_sizes(self, ctx: _SigCtx) -> None:
        ctx.seen_transparent.add(id(self))
        ctx.elementwise_sizes.append(self.vec.size)

    def _sig(self, ctx: _SigCtx) -> str:
        s = ctx.slot(self)
        if ctx.transparent:
            ctx.elementwise_sizes.append(self.vec.size)
        return f"v{s}"

    def leaf_key(self) -> Any:
        return ("buf", id(self.vec.storage))

    def payload(self) -> Any:
        return self.vec.storage

    def infer(self, types):
        types[id(self)] = code = code_of(self.vec.dtype)
        return code

    def size_hint(self) -> Optional[int]:
        return self.vec.size


class ArrayTerminal(_ArrayLeaf):
    """A raw 1-D tensor or numpy array leaf (numpy arrays move to the
    evaluation device)."""

    _opname = "a"

    def __init__(self, array):
        if isinstance(array, np.ndarray):
            array = torch.from_numpy(np.ascontiguousarray(array))
        self.array = array

    def _sig(self, ctx: _SigCtx) -> str:
        s = ctx.slot(self)
        return f"a{s}r{self.array.ndim}"

    def leaf_key(self) -> Any:
        return ("buf", id(self.array))

    def payload(self) -> Any:
        return self.array

    def infer(self, types):
        types[id(self)] = code = code_of(self.array.dtype)
        return code

    def size_hint(self) -> Optional[int]:
        return int(self.array.shape[0]) if self.array.ndim == 1 else None


class ScalarTerminal(Expr):
    """A runtime scalar — a kernel argument, not part of the signature,
    so ``x = a*y`` reuses one kernel for every value of ``a``."""

    _opname = "s"

    def __init__(self, value):
        self.value = value

    def _sig(self, ctx: _SigCtx) -> str:
        return f"s{ctx.slot(self)}"

    def leaf_key(self) -> Any:
        return ("scalar", id(self))

    def payload(self) -> Any:
        return self.value

    def infer(self, types):
        types[id(self)] = code = scalar_code(self.value)
        return code

    def emit(self, env: EmitEnv):
        return env.leaf(self)

    def emit_src(self, em) -> str:
        return em.scalar(self)

    def size_hint(self) -> Optional[int]:
        return None


class ConstantTerminal(Expr):
    """A compile-time constant baked into the kernel (VEX_CONSTANT,
    constants.hpp:52-142).  Its value is part of the signature."""

    _opname = "c"

    def __init__(self, value, name: str = ""):
        self.value = value
        self.name = name or repr(value)

    def extra_sig(self) -> str:
        return self.name

    def infer(self, types):
        types[id(self)] = code = scalar_code(self.value)
        return code

    def emit(self, env: EmitEnv):
        return torch.tensor(self.value, device=env.device,
                            dtype=dtype_of_code(env.types[id(self)]))

    def emit_src(self, em) -> str:
        return em.constant(self.value, em.types[id(self)])

    def size_hint(self) -> Optional[int]:
        return None


class ElementIndex(Expr):
    """Global element index terminal (element_index.hpp:38-58): i64
    ``offset + i`` at the expression's output size."""

    _opname = "idx"

    def __init__(self, offset: int = 0, length: Optional[int] = None):
        self.offset = offset
        self.length = length

    def extra_sig(self) -> str:
        return f"{self.offset}:{self.length}"

    def infer(self, types):
        types[id(self)] = "i64"
        return "i64"

    def emit(self, env: EmitEnv):
        n = self.length if self.length is not None else env.n
        if n is None:
            raise ValueError(
                "element_index() needs an explicit length or a sized "
                "expression")
        return torch.arange(self.offset, self.offset + n, dtype=torch.int64,
                            device=env.device)

    def emit_src(self, em) -> str:
        # beneath a view this is the index the view computed: the JAX
        # package evaluates a view's inner expression over its own length
        return em.define(f"({em.index64()} + {int(self.offset)})")

    def size_hint(self) -> Optional[int]:
        return self.length


class TaggedTerminal(Expr):
    """vex::tag<N>(x): occurrences with one tag share one kernel argument
    (tagged_terminal.hpp:50-269)."""

    _opname = "tag"

    def __init__(self, tag_id: Any, inner: Expr):
        self.tag_id = tag_id
        self.inner = inner

    def _sig(self, ctx: _SigCtx) -> str:
        return f"t{ctx.slot(self)}"

    def leaf_key(self) -> Any:
        return ("tag", self.tag_id)

    def payload(self) -> Any:
        if isinstance(self.inner, (VectorTerminal, ArrayTerminal,
                                   ScalarTerminal)):
            return self.inner.payload()
        raise TypeError("tag() expects a vector/array/scalar terminal")

    def infer(self, types):
        types[id(self)] = code = self.inner.infer(types)
        return code

    def emit(self, env: EmitEnv):
        return env.leaf(self)

    def emit_src(self, em) -> str:
        if isinstance(self.inner, ScalarTerminal):
            return em.scalar(self)
        return em.load(self)

    def size_hint(self) -> Optional[int]:
        return self.inner.size_hint()


class Temporary(Expr):
    """vex::make_temp<Tag>(expr): evaluate a subexpression once and reuse
    the value (temporary.hpp:49-108)."""

    _opname = "tmp"

    def __init__(self, tag_id: Any, inner: Expr):
        self.tag_id = tag_id
        self.children = (inner,)

    def extra_sig(self) -> str:
        return str(self.tag_id)

    def _infer(self, child_codes):
        return child_codes[0]

    def emit(self, env: EmitEnv):
        key = ("temp", self.tag_id)
        if key not in env.temps:
            env.temps[key] = self.children[0].emit_cached(env)
        return env.temps[key]

    def emit_src(self, em) -> str:
        key = ("temp", self.tag_id)
        if key not in em.temps:
            em.temps[key] = em.value(self.children[0])
        return em.temps[key]


# ---------------------------------------------------------------------------
# Public constructors
# ---------------------------------------------------------------------------


def as_expr(x: Any) -> Expr:
    """Coerce any operand to an expression node."""
    if isinstance(x, Expr):
        return x
    if hasattr(x, "_as_terminal"):
        return x._as_terminal()
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return ArrayTerminal(x)
    if isinstance(x, (int, float, complex, bool, np.generic)):
        return ScalarTerminal(x)
    raise TypeError(f"cannot use {type(x)!r} in a vector expression")


def element_index(offset: int = 0, length: Optional[int] = None) -> ElementIndex:
    return ElementIndex(offset, length)


def tag(tag_id: Any, x: Any = None):
    """``tag(7)(x)`` or ``tag(7, x)`` — mirror of vex::tag<7>(x)."""
    if x is None:
        return lambda y: TaggedTerminal(tag_id, as_expr(y))
    return TaggedTerminal(tag_id, as_expr(x))


def make_temp(tag_id: Any, expr: Any):
    """vex::make_temp<Tag>(expr) (temporary.hpp:49-108).  Over a
    multivector expression it lifts componentwise (temporary.cpp
    multivector_temporary): component i gets the tag (tag_id, i), so the
    components of one fused kernel never share a value."""
    if getattr(expr, "_multi", False):
        from ..multivector import MultiExpr, parts

        return MultiExpr([Temporary((tag_id, i), c)
                          for i, c in enumerate(parts(expr))])
    return Temporary(tag_id, as_expr(expr))


def constant(value, name: str = "") -> ConstantTerminal:
    return ConstantTerminal(value, name)


def cast(dtype, expr: Any) -> CastExpr:
    return CastExpr(dtype, expr)


def if_else(cond: Any, a: Any, b: Any) -> Where:
    return Where(as_expr(cond), as_expr(a), as_expr(b))


def expression_properties(expr: Expr):
    """(size, context) of an expression (get_expression_properties,
    operations.hpp:1411): the context of its first vector terminal; the
    size of the first one outside any SpMV, else the size hint (an
    SpMV's row count, so ``Sum(A * x)`` works for rectangular A)."""
    from ..context import current_context

    terms = expr.vector_terminals()
    ctx = terms[0].vec.context if terms else current_context(required=False)
    sized = expr.vector_terminals(sized_only=True)
    return (sized[0].vec.size if sized else expr.size_hint()), ctx

