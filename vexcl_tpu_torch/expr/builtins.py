"""Builtin device-function catalog.

Port of ``vexcl_tpu/expr/builtins.py`` (vexcl/function.hpp builtin
catalog).  The catalog is a table ``name -> (type rule, PyTorch form,
kernel form)``:

* the type rule follows the jnp function the JAX package maps the name
  to: ``"inexact"`` (promote, then make floating: ``sin`` of i32 is f32),
  ``"join"`` (promote only: ``fmin``, ``floor``, ``fabs`` keep an integer
  type; ``"join_real"`` the same, refusing complex values: ``ceil``),
  ``"numeric"`` (``fmod``, ``pow``: booleans computed as i32, two
  integers give an integer), ``"float"`` (an integer becomes the default
  float type: ``rint`` and ``exp10`` of i32 are f64), ``"weak_inexact"``
  (promoted with a weak float, as ``sin(pi * x)``: ``sinpi`` of i32 is a
  weak f64, of f32 f32), ``"bool"`` (classification), ``"real"``
  (promote; a complex value gives the type of its parts: ``abs``,
  ``real`` and ``imag`` of c64 are f32), and the rules of one or a few
  entries each (``node._result_code``): ``"int"`` (integer types only:
  ``popcount``, ``add_sat``, ``mul_hi``, ...), ``"int_numeric"``
  (``rotate``: booleans as i32), ``"select"`` (the condition apart),
  ``"step"`` (x's type), ``"join_inexact"`` (``smoothstep``: differences
  in the operands' type, the result inexact), ``"msb"`` (``any``,
  ``all``: i32), ``"ilogb"`` (``ilogb``, ``frexp_exp``: i32 of an
  inexact value), ``"nan"`` (f32), ``"gamma_sign"`` (the weak default
  integer), ``"ldexp"`` (an integer exponent, as i64) and ``"upsample"``
  (twice the high half's width: 8 to 16, 16 to 32, 32 to 64 bits);
* the PyTorch form gets its operands already cast to their compute types
  and serves CPU tensors; a form marked ``typed`` (the integer helpers)
  takes the operands' codes and the result code first, and computes on
  i64 values itself (PyTorch's CPU kernels lack most operations on u16,
  u32 and u64);
* the kernel form is the spelling in the generated Triton source, with
  ``{0}``, ``{1}`` ... for the operands, or the name of a form that
  ``triton_emit.py`` defines (``"min"``, ``"popcount"``, ``"tgamma"``,
  ...).  A kernel form spells its plain form's formula (``sinpi`` is
  sin(pi x) in the compute type, ``tgamma`` the reflection formula), so
  that the card holds the two within a few ulp; the integer helpers map to
  libdevice where it computes the same thing (``mulhi``, ``popc``,
  ``clz``, ``ilogb``, ``ldexp``).  ``libdevice`` is Triton's CUDA
  libdevice binding: ``tl.exp``, ``tl.sqrt`` and ``/`` lower to
  approximate PTX instructions in f32 on the installed Triton, so the
  kernel spells the correctly rounded libdevice functions.

Every entry has a kernel form for real types.  On complex values the
kernel covers ``real``, ``imag``, ``conj``, ``abs`` (the magnitude,
``libdevice.hypot``), ``sign`` (x/|x|) and the rounding of each part
(``round``, ``rint``, ``nearbyint``) as (re, im) pairs
(``triton_emit.Emitter.complex_op``); every other builtin of a complex
value raises ``NotImplementedError`` on CUDA and computes on the CPU.
Where the JAX package computes another thing than OpenCL, the port
computes OpenCL's definition (ROADMAP.md §3): ``mad_hi`` is
``mul_hi(a, b) + c``, ``mul_hi`` and ``mad_sat`` of 64-bit integers
take the full product, ``rotate`` shifts logically and ``ilogb(0)`` is
INT_MIN.  ``sincos``, ``modf``, ``frexp``, ``remquo`` and ``lgamma_r``
return pairs of expressions; ``dot``, ``length``, ``distance``,
``normalize``, ``cross`` and ``shuffle``/``shuffle2`` work on the
components of a multivector, a ``MultiExpr`` or a tuple.
Applied to plain numbers or tensors a builtin computes eagerly (the
VEX_DUAL_FUNCTOR behaviour, function.hpp:243): on tensors it returns a
tensor; on plain Python numbers a Python number, computed in f64 or i64
(``jnp`` keeps such a result weakly typed, so ``sin(2.0) + x`` has x's
type in both packages); applied to a multivector
or a multivector expression, it applies componentwise.
"""

from __future__ import annotations

import builtins as _py
import math
from typing import Optional

import torch

from ..types import code_of, dtype_of_code, scalar_code
from .node import (_BINOPS, _CARRIER, _I64_MIN, _INT_WIDTH, BinOp,
                   ConstantTerminal, Expr, FuncCall, Where, _carried, _lshr64,
                   _ult64, as_expr, fmod, plain_apply, sign)

__all__ = ["builtin", "BUILTINS"]


class builtin:
    """A named device function usable in expressions and on plain values."""

    def __init__(self, name: str, entry):
        self.name = name
        self.entry = entry
        self.__name__ = name

    @property
    def kernel_form(self) -> Optional[str]:
        return self.entry[2]

    @property
    def nargs(self) -> int:
        """The number of operands."""
        return _ARITY.get(self.name, 1)

    def __call__(self, *args):
        if len(args) != self.nargs:
            raise TypeError(f"{self.name}() takes {self.nargs} operand"
                            f"{'s' if self.nargs > 1 else ''} "
                            f"({len(args)} given)")
        # this module's globals hold the device functions ``any``, ``all``,
        # ``min``, ``max`` and ``abs``: Python's own are ``_py.*``
        if _py.any(getattr(a, "_multi", False) for a in args):
            from ..multivector import lift

            return lift(self, args)
        if _py.any(isinstance(a, Expr) or hasattr(a, "_as_terminal")
                   for a in args):
            return FuncCall(self.name, self.entry, [as_expr(a) for a in args])
        typed = getattr(self.entry[1], "typed", False)
        if _py.all(type(a) in _WEAK for a in args):
            # plain Python numbers: jnp computes them weakly typed (f64 in
            # 64-bit mode) and the result stays weak, so it comes back as a
            # Python number, which an expression takes as a weak scalar
            if typed:
                return plain_apply(self.name, self.entry, [
                    torch.tensor(a, dtype=_WEAK[type(a)]) for a in args],
                    [scalar_code(a) for a in args]).item()
            inexact = self.entry[0] in ("inexact", "float", "weak_inexact")
            vals = [torch.tensor(a, dtype=torch.float64 if inexact and type(
                a) in (bool, int) else _WEAK[type(a)]) for a in args]
            return self.entry[1](*vals).item()
        vals = [torch.as_tensor(a) for a in args]
        if typed:
            return plain_apply(self.name, self.entry, vals,
                               [code_of(v.dtype) for v in vals])
        return self.entry[1](*vals)

    def __repr__(self):
        return f"<device function {self.name}>"


#: the types of plain Python numbers and the widest dtype of their kind
_WEAK = {bool: torch.bool, int: torch.int64, float: torch.float64,
         complex: torch.complex128}


def _ld(fn: str, nargs: int = 1) -> str:
    return f"libdevice.{fn}(" + ", ".join(f"{{{i}}}" for i in range(nargs)) + ")"


def _tgamma(x):
    # the JAX package's form: exp(lgamma) with the reflection formula
    return torch.where(
        x > 0, torch.exp(torch.lgamma(x)),
        math.pi / (torch.sin(math.pi * x) * torch.exp(torch.lgamma(1.0 - x))))


def _imag(x):
    # jnp.imag of a real value: zeros of its type
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def _rootn(x, n):
    return sign(x) * torch.abs(x) ** (1.0 / n)


def _select(codes, rc, a, b, c):
    """jnp.where(c, b, a): c (a boolean) picks b."""
    if codes[0] in _CARRIER:        # no unsigned where on the CPU
        return _carried("where", torch.where, [b, a], codes[0], a.dtype, c)
    return torch.where(c, b, a)


_select.typed = True


# ---------------------------------------------------------------------------
# Integer helpers.  Their PyTorch forms compute on i64 tensors that hold
# each operand's value (a u64 operand: its bits), with the width and the
# signedness of its type (PyTorch's CPU kernels lack most operations on
# u16, u32 and u64), and give the result back in its type.  Where the JAX
# package computes another thing than OpenCL (ROADMAP.md §3), these
# compute OpenCL's definition: ``mul_hi`` and ``mad_sat`` of 64-bit
# integers from the full product, ``mad_hi`` as mul_hi(a, b) + c,
# ``rotate`` by a logical shift.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _typed(fn):
    """Mark a PyTorch form that takes (operand codes, result code, *args)
    (``node.plain_apply``)."""
    fn.typed = True
    return fn


def _wide(t: torch.Tensor, code: str) -> torch.Tensor:
    """An integer tensor of type ``code`` as i64 values (u64: its bits)."""
    if t.dtype == torch.uint64:
        return t.view(torch.int64)
    return t.to(torch.int64)


def _narrow(v: torch.Tensor, code: str) -> torch.Tensor:
    """i64 values in the range of ``code`` (u64: bits) as that type."""
    if code == "u64":
        return v.view(torch.uint64)
    return v.to(dtype_of_code(code))


def _mask(w: int) -> int:
    """The low ``w`` bits, as an i64 value (all 64: -1)."""
    return -1 if w == 64 else (1 << w) - 1


def _wrap(v: torch.Tensor, w: int, signed: bool) -> torch.Tensor:
    """i64 values reduced modulo 2^w into a w-bit type's range."""
    if w == 64:
        return v
    v = v & _mask(w)
    if signed:
        top = 1 << (w - 1)
        v = (v ^ top) - top
    return v


def _lt(a: torch.Tensor, b: torch.Tensor, code: str) -> torch.Tensor:
    """a < b for operands of type ``code`` (unsigned ones compared as
    such)."""
    if code in _CARRIER:
        a, b = _wide(a, code), _wide(b, code)
        if code == "u64":
            return _ult64(a, b)
    return a < b


def _popcount64(v: torch.Tensor) -> torch.Tensor:
    """The set bits of i64 words (SWAR; arithmetic shifts are masked)."""
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (v * 0x0101010101010101) >> 56


def _bit_length64(v: torch.Tensor) -> torch.Tensor:
    """The bit length of i64 words read as unsigned."""
    n = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        t = _lshr64(v, s)
        nz = t != 0
        n = n + torch.where(nz, s, 0)
        v = torch.where(nz, t, v)
    return n + (v != 0).to(torch.int64)


@_typed
def _popcount(codes, rc, x):
    w = _INT_WIDTH[codes[0]]
    return _narrow(_popcount64(_wide(x, codes[0]) & _mask(w)), rc)


@_typed
def _clz(codes, rc, x):
    w = _INT_WIDTH[codes[0]]
    return _narrow(w - _bit_length64(_wide(x, codes[0]) & _mask(w)), rc)


@_typed
def _rotate(codes, rc, x, s):
    """OpenCL rotate: x rotated left by s modulo its width."""
    code = codes[0]
    w = _INT_WIDTH[code]
    v = _wide(x, code) & _mask(w)
    k = _wide(s, code) & (w - 1)
    r = (v << k) | _lshr64(v, (w - k) & (w - 1))
    return _narrow(_wrap(r, w, code[0] == "i"), rc)


def _limits(code: str):
    info = torch.iinfo(dtype_of_code(code))
    return info.min, info.max


@_typed
def _add_sat(codes, rc, a, b):
    code = codes[0]
    w, (lo, hi) = _INT_WIDTH[code], _limits(code)
    a, b = _wide(a, code), _wide(b, code)
    s = a + b                        # i64 arithmetic wraps
    if w < 64:
        return _narrow(s.clamp(lo, hi), rc)
    if code == "u64":
        return _narrow(torch.where(_ult64(s, a), -1, s), rc)
    up = (a > 0) & (b > 0) & (s < 0)
    dn = (a < 0) & (b < 0) & (s >= 0)
    return _narrow(torch.where(up, hi, torch.where(dn, lo, s)), rc)


@_typed
def _sub_sat(codes, rc, a, b):
    code = codes[0]
    w, (lo, hi) = _INT_WIDTH[code], _limits(code)
    a, b = _wide(a, code), _wide(b, code)
    s = a - b
    if w < 64:
        return _narrow(s.clamp(lo, hi), rc)
    if code == "u64":
        return _narrow(torch.where(_ult64(a, b), 0, s), rc)
    up = (a >= 0) & (b < 0) & (s < 0)
    dn = (a < 0) & (b > 0) & (s >= 0)
    return _narrow(torch.where(up, hi, torch.where(dn, lo, s)), rc)


def _mul_hi64(a: torch.Tensor, b: torch.Tensor, signed: bool):
    """The high word of the 128-bit product of i64 words (read as signed
    or unsigned), from 32-bit halves."""
    a0, a1 = a & _M32, _lshr64(a, 32)
    b0, b1 = b & _M32, _lshr64(b, 32)
    p01, p10 = a0 * b1, a1 * b0
    mid = _lshr64(a0 * b0, 32) + (p01 & _M32) + (p10 & _M32)
    hi = a1 * b1 + _lshr64(p01, 32) + _lshr64(p10, 32) + _lshr64(mid, 32)
    if signed:
        hi = hi - torch.where(a < 0, b, 0) - torch.where(b < 0, a, 0)
    return hi


def _mul_hi_wide(code: str, a: torch.Tensor, b: torch.Tensor):
    """mul_hi of i64-held operands of type ``code``, as i64 values."""
    w, signed = _INT_WIDTH[code], code[0] == "i"
    if w == 64:
        return _mul_hi64(a, b, signed)
    p = a * b                        # exact, or (u32) its 64 bits
    return p >> w if signed else _lshr64(p, w)


@_typed
def _mul_hi(codes, rc, a, b):
    code = codes[0]
    return _narrow(_mul_hi_wide(code, _wide(a, code), _wide(b, code)), rc)


@_typed
def _mad_hi(codes, rc, a, b, c):
    code = codes[0]
    hi = _mul_hi_wide(code, _wide(a, code), _wide(b, code))
    return _narrow(_wrap(hi + _wide(c, code), _INT_WIDTH[code],
                         code[0] == "i"), rc)


@_typed
def _mad_sat(codes, rc, a, b, c):
    """a*b + c on the exact product, saturated to the type's range."""
    code = codes[0]
    w, (lo, hi) = _INT_WIDTH[code], _limits(code)
    a, b, c = (_wide(t, code) for t in (a, b, c))
    if w < 32 or code == "i32":
        return _narrow((a * b + c).clamp(lo, hi), rc)
    p = a * b                        # the low 64 bits of the product
    s = p + c
    carry = _ult64(s, p)             # an unsigned carry out of the sum
    if code == "u32":
        return _narrow(torch.where(carry | _ult64(_M32, s), _M32, s), rc)
    if code == "u64":
        over = (_mul_hi64(a, b, False) != 0) | carry
        return _narrow(torch.where(over, -1, s), rc)
    # i64: the 128-bit sum (hi:p) + (c >> 63 : c) fits 64 bits where its
    # high word is the sign extension of its low one
    top = _mul_hi64(a, b, True) + (c >> 63) + carry.to(torch.int64)
    fits = top == (s >> 63)
    return _narrow(torch.where(fits, s, torch.where(top < 0, _I64_MIN,
                                                    hi)), rc)


@_typed
def _upsample(codes, rc, hi, lo):
    """(hi << w) | lo in the type of twice hi's width w (lo already the
    unsigned w-bit type)."""
    w = _INT_WIDTH[codes[0]]
    return _narrow((_wide(hi, codes[0]) << w) | _wide(lo, codes[1]), rc)


@_typed
def _msb(codes, rc, x):
    """OpenCL's scalar any/all: 1 where x is below 0 (its sign bit; none
    in unsigned and boolean types)."""
    if x.dtype.is_floating_point or x.dtype.is_signed:
        return (x < 0).to(torch.int32)
    return torch.zeros(x.shape, dtype=torch.int32, device=x.device)


@_typed
def _step(codes, rc, edge, x):
    """0 where x < edge, else 1 (NaN: 1), in x's type."""
    return (~_lt(x, edge, codes[0])).to(dtype_of_code(rc))


def _magnitude(pick_ge: bool):
    """maxmag (the operand of the larger magnitude, a on a tie) or minmag
    (the smaller, a on a tie); booleans: or, and."""
    @_typed
    def form(codes, rc, a, b):
        code = codes[0]
        if code == "b1":
            return (a | b) if pick_ge else (a & b)
        if code in _CARRIER:
            # unsigned: the magnitude is the value
            wa, wb = _wide(a, code), _wide(b, code)
            lt = _ult64(wa, wb) if code == "u64" else wa < wb
            first = ~lt if pick_ge else lt | (wa == wb)
            return _narrow(torch.where(first, wa, wb), rc)
        ma, mb = torch.abs(a), torch.abs(b)
        return torch.where(ma >= mb if pick_ge else ma <= mb, a, b)
    return form


def _one_below(dtype: torch.dtype) -> float:
    """The largest value of ``dtype`` below 1."""
    return 1.0 - torch.finfo(dtype).eps / 2


def _fract(x):
    """OpenCL fract: x - floor(x), at most the value below 1."""
    return torch.minimum(x - torch.floor(x), torch.tensor(
        _one_below(x.dtype), dtype=x.dtype, device=x.device))


@_typed
def _smoothstep(codes, rc, e0, e1, x):
    """jnp's smoothstep: the differences in the operands' type (integers
    wrap), the rest in the inexact type."""
    sub, dt = _BINOPS["sub"], dtype_of_code(rc)
    d = [plain_apply("sub", sub, [a, b], codes[:2]).to(dt)
         for a, b in ((x, e0), (e1, e0))]
    t = torch.clamp(d[0] / d[1], 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _ilogb(x):
    """OpenCL ilogb: the unbiased exponent; INT_MIN at 0 and NaN
    (FP_ILOGB0, FP_ILOGBNAN as CUDA defines them), INT_MAX at infinity."""
    e = torch.frexp(x).exponent - 1
    e = torch.where((x == 0) | torch.isnan(x), -(1 << 31), e)
    return torch.where(torch.isinf(x), (1 << 31) - 1, e)


def _pow2(e: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2^e (i64 e) in ``dtype`` from its bits: exact where representable,
    a subnormal power included; 0 below, infinity above."""
    bits, bias = {torch.float32: (23, 127),
                  torch.float64: (52, 1023)}[dtype]
    top = 2 * bias
    ints = torch.where(e > -bias, (e.clamp(-bias + 1, bias) + bias) << bits,
                       1 << (e + bias - 1 + bits).clamp(0, bits))
    ints = torch.where(e < -bias + 1 - bits, 0, ints)
    ints = torch.where(e > bias, (top + 1) << bits, ints)
    itype = torch.int32 if dtype == torch.float32 else torch.int64
    return ints.to(itype).view(dtype)


def _ldexp(x, n):
    """x * 2^n rounded once (OpenCL ldexp, libdevice's), as the JAX
    package computes it on normal results: from frexp's mantissa, so that
    no intermediate power overflows.  Half types go through f32."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return _ldexp(x.float(), n).to(x.dtype)
    m, e = torch.frexp(x)
    e = e.to(torch.int64) + n.clamp(-100000, 100000)
    # the exponent may overflow by one and still give a finite result
    m = torch.where(e > 0, m * 2, m)
    e = torch.where(e > 0, e - 1, e)
    return torch.where(torch.isinf(x) | (x == 0), x, m * _pow2(e, x.dtype))


def _frexp_mant(x):
    return torch.frexp(x).mantissa


def _frexp_exp(x):
    return torch.frexp(x).exponent


def _gamma_sign(x):
    """The sign of gamma(x): 1 for x > 0 or an even floor, else -1."""
    one = torch.ones(x.shape, dtype=torch.int64, device=x.device)
    return torch.where((x > 0) | (torch.floor(x * 0.5) * 2 == torch.floor(x)),
                       one, -one)


@_typed
def _nan(codes, rc, code):
    return torch.full(code.shape, math.nan, dtype=torch.float32,
                      device=code.device)


def _parts(fn):
    """``fn`` of a real value; of a complex value, of each part (jnp.round
    and jnp.rint round the real and imaginary parts)."""
    def form(x):
        if x.is_complex():
            return torch.complex(fn(x.real), fn(x.imag))
        return fn(x) if x.is_floating_point() else x
    return form


_CATALOG = {
    # trigonometric
    "sin": ("inexact", torch.sin, _ld("sin")),
    "cos": ("inexact", torch.cos, _ld("cos")),
    "tan": ("inexact", torch.tan, _ld("tan")),
    "asin": ("inexact", torch.asin, _ld("asin")),
    "acos": ("inexact", torch.acos, _ld("acos")),
    "atan": ("inexact", torch.atan, _ld("atan")),
    "atan2": ("inexact", torch.atan2, _ld("atan2", 2)),
    "sinpi": ("weak_inexact", lambda x: torch.sin(math.pi * x), "pi:sin"),
    "cospi": ("weak_inexact", lambda x: torch.cos(math.pi * x), "pi:cos"),
    "tanpi": ("weak_inexact", lambda x: torch.tan(math.pi * x), "pi:tan"),
    "asinpi": ("inexact", lambda x: torch.asin(x) / math.pi, "/pi:asin"),
    "acospi": ("inexact", lambda x: torch.acos(x) / math.pi, "/pi:acos"),
    "atanpi": ("inexact", lambda x: torch.atan(x) / math.pi, "/pi:atan"),
    "atan2pi": ("inexact", lambda y, x: torch.atan2(y, x) / math.pi,
                "/pi:atan2"),
    # hyperbolic
    "sinh": ("inexact", torch.sinh, _ld("sinh")),
    "cosh": ("inexact", torch.cosh, _ld("cosh")),
    "tanh": ("inexact", torch.tanh, _ld("tanh")),
    "asinh": ("inexact", torch.asinh, _ld("asinh")),
    "acosh": ("inexact", torch.acosh, _ld("acosh")),
    "atanh": ("inexact", torch.atanh, _ld("atanh")),
    # exponential / log
    "exp": ("inexact", torch.exp, _ld("exp")),
    "exp2": ("inexact", torch.exp2, _ld("exp2")),
    "exp10": ("float", lambda x: torch.pow(10.0, x), _ld("exp10")),
    "expm1": ("inexact", torch.expm1, _ld("expm1")),
    "log": ("inexact", torch.log, _ld("log")),
    "log2": ("inexact", torch.log2, _ld("log2")),
    "log10": ("inexact", torch.log10, _ld("log10")),
    "log1p": ("inexact", torch.log1p, _ld("log1p")),
    "logb": ("inexact", lambda x: torch.floor(torch.log2(torch.abs(x))),
             "libdevice.floor(libdevice.log2(tl.abs({0})))"),
    # power / roots
    "pow": ("numeric", torch.pow, "pow"),
    "powr": ("numeric", torch.pow, "pow"),
    "pown": ("numeric", torch.pow, "pow"),
    "sqrt": ("inexact", torch.sqrt, _ld("sqrt_rn")),
    "rsqrt": ("inexact", torch.rsqrt, _ld("rsqrt")),
    "cbrt": ("inexact", lambda x: sign(x) * torch.abs(x) ** (1.0 / 3),
             _ld("cbrt")),
    "rootn": ("weak_inexact", _rootn, "rootn"),
    "hypot": ("inexact", torch.hypot, _ld("hypot", 2)),
    # rounding (integers pass through, as with jnp; rint and nearbyint
    # cast them to the default float type; a complex value rounds each
    # part, and ceil, floor and trunc refuse it)
    "ceil": ("join_real", _parts(torch.ceil), "ceil"),
    "floor": ("join_real", _parts(torch.floor), "floor"),
    "trunc": ("join_real", _parts(torch.trunc), "trunc"),
    "round": ("join", _parts(torch.round), "rint"),
    "rint": ("float", _parts(torch.round), "rint"),
    "nearbyint": ("float", _parts(torch.round), "rint"),
    # abs / sign / remainder
    "fabs": ("real", torch.abs, "tl.abs({0})"),
    "abs": ("real", torch.abs, "tl.abs({0})"),
    "sign": ("join", sign, "sign"),
    "fmod": ("numeric", fmod, "fmod"),
    "remainder": ("inexact", lambda x, y: x - torch.round(x / y) * y,
                  "({0} - libdevice.rint(libdevice.div_rn({0}, {1})) * {1})"),
    "copysign": ("inexact", torch.copysign, _ld("copysign", 2)),
    "nextafter": ("inexact", torch.nextafter, _ld("nextafter", 2)),
    "fdim": ("join", lambda a, b: torch.maximum(a - b, torch.zeros_like(a)),
             "max0"),
    "abs_diff": ("join", lambda a, b: torch.abs(a - b), "tl.abs({0} - {1})"),
    # min/max/clamp family (NaN-propagating, as jnp.minimum/maximum)
    "fmin": ("join", torch.minimum, "min"),
    "fmax": ("join", torch.maximum, "max"),
    "min": ("join", torch.minimum, "min"),
    "max": ("join", torch.maximum, "max"),
    "clamp": ("join",
              lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi),
              "clamp"),
    "mix": ("join", lambda x, y, a: x + (y - x) * a, "({0} + ({1} - {0}) * {2})"),
    "step": ("step", _step, "step"),
    "smoothstep": ("join_inexact", _smoothstep, "smoothstep"),
    "maxmag": ("join", _magnitude(True), "maxmag"),
    "minmag": ("join", _magnitude(False), "minmag"),
    # fused / fast arithmetic
    "mad": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "fma": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "mad24": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "mul24": ("join", lambda a, b: a * b, "({0} * {1})"),
    "mad_hi": ("int", _mad_hi, "mad_hi"),
    # special functions
    "erf": ("inexact", torch.erf, _ld("erf")),
    "erfc": ("inexact", torch.erfc, _ld("erfc")),
    "lgamma": ("inexact", torch.lgamma, _ld("lgamma")),
    "tgamma": ("inexact", _tgamma, "tgamma"),
    # classification
    "isnan": ("bool", torch.isnan, "({0} != {0})"),
    "isinf": ("bool", torch.isinf, "(tl.abs({0}) == float('inf'))"),
    "isfinite": ("bool", torch.isfinite, "(tl.abs({0}) < float('inf'))"),
    "isnormal": ("bool", lambda x: torch.isfinite(x) & (x != 0), "isnormal"),
    "signbit": ("bool", torch.signbit, "signbit"),
    "isequal": ("bool", torch.eq, "({0} == {1})"),
    "isnotequal": ("bool", torch.ne, "({0} != {1})"),
    "isgreater": ("bool", torch.gt, "({0} > {1})"),
    "isgreaterequal": ("bool", torch.ge, "({0} >= {1})"),
    "isless": ("bool", torch.lt, "({0} < {1})"),
    "islessequal": ("bool", torch.le, "({0} <= {1})"),
    "islessgreater": ("bool", torch.ne, "({0} != {1})"),
    "isordered": ("bool", lambda a, b: ~(torch.isnan(a) | torch.isnan(b)),
                  "(({0} == {0}) & ({1} == {1}))"),
    "isunordered": ("bool", lambda a, b: torch.isnan(a) | torch.isnan(b),
                    "(({0} != {0}) | ({1} != {1}))"),
    # conversions / bit operations
    "degrees": ("inexact", torch.rad2deg, "degrees"),
    "radians": ("inexact", torch.deg2rad, "radians"),
    "ldexp": ("ldexp", _ldexp, "ldexp"),
    "popcount": ("int", _popcount, "popcount"),
    "clz": ("int", _clz, "clz"),
    "rotate": ("int_numeric", _rotate, "rotate"),
    # selection (jnp.where(c, b, a): c is not promoted with a and b)
    "select": ("select", _select, "tl.where({2}, {1}, {0})"),
    "bitselect": ("join", lambda a, b, c: (a & ~c) | (b & c),
                  "(({0} & ~{2}) | ({1} & {2}))"),
    # complex parts (jnp.real, jnp.imag, jnp.conj; a real value is its own
    # real part and conjugate, its imaginary part zeros of its type)
    "real": ("real", torch.real, "real"),
    "imag": ("real", _imag, "imag"),
    "conj": ("join", _conj, "conj"),
    # saturating / carry-less integer arithmetic
    "hadd": ("join", lambda a, b: (a & b) + ((a ^ b) >> 1),
             "(({0} & {1}) + (({0} ^ {1}) >> 1))"),
    "rhadd": ("join", lambda a, b: (a | b) - ((a ^ b) >> 1),
              "(({0} | {1}) - (({0} ^ {1}) >> 1))"),
    "add_sat": ("int", _add_sat, "add_sat"),
    "sub_sat": ("int", _sub_sat, "sub_sat"),
    "mad_sat": ("int", _mad_sat, "mad_sat"),
    "mul_hi": ("int", _mul_hi, "mul_hi"),
    "upsample": ("upsample", _upsample, "upsample"),
    "__popc": ("int", _popcount, "popcount"),
    "__popcll": ("int", _popcount, "popcount"),
    # scalar any/all (the sign bit, OpenCL's relational chapter)
    "any": ("msb", _msb, "msb"),
    "all": ("msb", _msb, "msb"),
    # float decomposition and classification
    "fract": ("inexact", _fract, "fract"),
    "ilogb": ("ilogb", _ilogb, "ilogb"),
    "nan": ("nan", _nan, "nan"),
}

#: catalog entries that are not module names (the JAX package's hidden
#: entries, reached through ``frexp`` and ``lgamma_r``)
_HIDDEN = {
    "frexp_mant": ("inexact", _frexp_mant, "frexp_mant"),
    "frexp_exp": ("ilogb", _frexp_exp, "frexp_exp"),
    "gamma_sign": ("gamma_sign", _gamma_sign, "gamma_sign"),
}

#: the number of operands of the entries that take more than one
_ARITY = {
    "atan2": 2, "atan2pi": 2, "pow": 2, "powr": 2, "pown": 2, "rootn": 2,
    "hypot": 2, "fmod": 2, "remainder": 2, "copysign": 2, "nextafter": 2,
    "fdim": 2, "abs_diff": 2, "fmin": 2, "fmax": 2, "min": 2, "max": 2,
    "clamp": 3, "mix": 3, "step": 2, "smoothstep": 3, "maxmag": 2,
    "minmag": 2, "mad": 3, "fma": 3, "mad24": 3, "mul24": 2, "mad_hi": 3,
    "isequal": 2, "isnotequal": 2, "isgreater": 2, "isgreaterequal": 2,
    "isless": 2, "islessequal": 2, "islessgreater": 2, "isordered": 2,
    "isunordered": 2, "ldexp": 2, "rotate": 2, "select": 3,
    "bitselect": 3, "hadd": 2, "rhadd": 2, "add_sat": 2, "sub_sat": 2,
    "mad_sat": 3, "mul_hi": 2, "upsample": 2,
}

BUILTINS = {name: builtin(name, entry) for name, entry in _CATALOG.items()}

globals().update(BUILTINS)
__all__ += list(BUILTINS)
BUILTINS.update((name, builtin(name, entry))
                for name, entry in _HIDDEN.items())

#: builtins that have a spelling in the CUDA expression kernel: all
KERNEL_BUILTINS = tuple(BUILTINS)


# -- multi-output builtins (OpenCL's pointer-argument forms): pairs of
# expressions, fused into one kernel by ``tie`` or a multivector ----------


def sincos(x):
    """OpenCL sincos(x, &c): (sin(x), cos(x))."""
    return BUILTINS["sin"](x), BUILTINS["cos"](x)


def modf(x):
    """(fractional, integral) parts, both with x's sign."""
    ip = BUILTINS["trunc"](x)
    return x - ip, ip


def frexp(x):
    """(mantissa in +-[0.5, 1), integer exponent)."""
    return BUILTINS["frexp_mant"](x), BUILTINS["frexp_exp"](x)


def remquo(x, y):
    """(remainder(x, y), the quotient rounded to nearest)."""
    return BUILTINS["remainder"](x, y), BUILTINS["rint"](x / y)


def lgamma_r(x):
    """(lgamma(x), the sign of gamma(x))."""
    return BUILTINS["lgamma"](x), BUILTINS["gamma_sign"](x)


__all__ += ["sincos", "modf", "frexp", "remquo", "lgamma_r"]


# -- geometric builtins over the components of a multivector, a
# MultiExpr or a tuple of expressions (OpenCL's geometric chapter on
# cl_vectorN) --------------------------------------------------------------


def _components(v):
    if getattr(v, "_multi", False):
        from ..multivector import parts

        return parts(v)
    if isinstance(v, (tuple, list)):
        return [as_expr(a) for a in v]
    return [as_expr(v)]


def _multi(components):
    from ..multivector import MultiExpr

    return MultiExpr(components)


def dot(a, b):
    """The components' dot product: one expression (not a matrix
    product)."""
    pa, pb = _components(a), _components(b)
    if len(pa) != len(pb):
        raise ValueError("dot: component counts differ")
    acc = None
    for x, y in zip(pa, pb):
        acc = x * y if acc is None else acc + x * y
    return acc


def length(a):
    return BUILTINS["sqrt"](dot(a, a))


def distance(a, b):
    return length(_multi([x - y for x, y in zip(_components(a),
                                                 _components(b))]))


def normalize(a):
    inv = BUILTINS["rsqrt"](dot(a, a))
    return _multi([x * inv for x in _components(a)])


def cross(a, b):
    (a0, a1, a2), (b0, b1, b2) = _components(a), _components(b)
    return _multi([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0])


fast_length = length
fast_distance = distance
fast_normalize = normalize


def shuffle(x, mask):
    """OpenCL shuffle with a static component mask: components of x in
    the mask's order (a per-element index is a gather: ``permutation``)."""
    p = _components(x)
    return _multi([p[int(i)] for i in mask])


def shuffle2(x, y, mask):
    p = _components(x) + _components(y)
    return _multi([p[int(i)] for i in mask])


__all__ += ["dot", "length", "distance", "normalize", "cross",
            "fast_length", "fast_distance", "fast_normalize",
            "shuffle", "shuffle2"]


# -- hidden helpers of the derivative rules: not catalog entries (the JAX
# package has no such builtins), each with a plain and a kernel form -------

#: digamma, the derivative of lgamma (``torch.digamma``; the kernel form
#: is the same recurrence and asymptotic series, ``triton_emit._digamma``)
DIGAMMA = builtin("digamma", ("inexact", torch.digamma, "digamma"))
#: the largest value below 1 of x's type (fract's bound), as a value of
#: x's shape
ONE_BELOW = builtin("one_below", ("join", lambda x: torch.full_like(
    x, _one_below(x.dtype)), "one_below"))


# -- derivative rules (``expr/adjoint.py``) --------------------------------
# One rule per catalog entry with a float result, as JAX differentiates
# the JAX package's form of it (jax/_src/lax/lax.py's jvp rules), at the
# kinks too: fabs is 1 at 0, a tie of fmin/fmax splits the gradient.  A
# rule takes the adjoint g of the call's value, the call node itself
# (its value, ``ans`` in JAX's rules) and the operands, each already cast
# to its compute type, and gives one contribution per operand (None where
# none flows); a rule marked ``typed`` takes the operands' own codes
# first.  A rule marked ``expands`` instead gives the composition the JAX
# package computes (``sinpi`` is sin(pi x), ``clamp`` jnp.clip's maximum
# and minimum, ``tgamma`` the reflection formula), which the adjoint
# differentiates node by node.  Each rule is an expression over catalog
# entries, so it runs through the plain forms and the emitter.  An entry
# without a derivative (``nextafter``, which JAX does not differentiate)
# has a string instead: the reason, which a gradient through it raises.


def _k(value: float) -> ConstantTerminal:
    """A float constant baked into the kernel, weakly typed (rounded to
    the type of the operand it meets, as JAX's ``_const(x, value)``)."""
    return ConstantTerminal(float(value))


def _expands(fn):
    fn.expands = True
    return fn


def _zero(g, out, *args):
    return (None,) * len(args)


def _balanced(x, z, y):
    """JAX's ``_balanced_eq``: 1 where x is the extreme z alone, 1/2 on a
    tie with y, else 0."""
    return Where(x == z, Where(y == z, _k(0.5), _k(1.0)), _k(0.0))


def _extreme(g, out, a, b):
    return g * _balanced(a, out, b), g * _balanced(b, out, a)


@_typed
def _pow(codes, g, out, a, b):
    """lax.pow: y x^(y - 1) (0 where an integer y is 0) and, for a float
    exponent, log(x) x^y (x = 0 taken as 1)."""
    jac = b * BinOp("pow", a, b - _k(1.0))
    if not dtype_of_code(codes[1]).is_floating_point:
        return g * Where(b == _k(0.0), _k(0.0), jac), None
    one_for_zero = Where(a == _k(0.0), _k(1.0), a)
    return g * jac, g * (_B["log"](one_for_zero) * out)


def _times(factor):
    """The rule of a function of one operand whose derivative is
    ``factor(x, out)``: g * factor."""
    return lambda g, out, x: (g * factor(x, out),)


def _smoothstep_tree(e0, e1, x):
    # jnp.clip(t, 0.0, 1.0): minimum(1, maximum(0, t))
    t = _B["fmin"](_k(1.0), _B["fmax"](_k(0.0), (x - e0) / (e1 - e0)))
    return t * t * (_k(3.0) - _k(2.0) * t)


def _abs_rule(g, out, x):
    return (Where(x >= _k(0.0), g, -g),)


_B = BUILTINS
_PI = _k(math.pi)
_SQRT_PI_2 = 2.0 / math.sqrt(math.pi)
_ONE = _k(1.0)

GRADIENTS = {
    "sin": _times(lambda x, o: _B["cos"](x)),
    "cos": lambda g, o, x: (-(g * _B["sin"](x)),),
    "tan": _times(lambda x, o: _ONE + o * o),
    "asin": _times(lambda x, o: _B["rsqrt"](_ONE - x * x)),
    "acos": _times(lambda x, o: -_B["rsqrt"](_ONE - x * x)),
    "atan": lambda g, o, x: (g / (_ONE + x * x),),
    "atan2": lambda g, o, y, x: (g * (x / (y * y + x * x)),
                                 g * (-y / (y * y + x * x))),
    "sinpi": _expands(lambda x: _B["sin"](_PI * x)),
    "cospi": _expands(lambda x: _B["cos"](_PI * x)),
    "tanpi": _expands(lambda x: _B["tan"](_PI * x)),
    "asinpi": _expands(lambda x: _B["asin"](x) / _PI),
    "acospi": _expands(lambda x: _B["acos"](x) / _PI),
    "atanpi": _expands(lambda x: _B["atan"](x) / _PI),
    "atan2pi": _expands(lambda y, x: _B["atan2"](y, x) / _PI),
    "sinh": _times(lambda x, o: _B["cosh"](x)),
    "cosh": _times(lambda x, o: _B["sinh"](x)),
    "tanh": lambda g, o, x: ((g + g * o) * (_ONE - o),),
    "asinh": _times(lambda x, o: _B["rsqrt"](x * x + _ONE)),
    "acosh": _times(lambda x, o: _B["rsqrt"](x * x - _ONE)),
    "atanh": lambda g, o, x: ((_ONE / (_ONE + x)) * (g / (_ONE - x)),),
    "exp": _times(lambda x, o: o),
    "exp2": lambda g, o, x: (_k(math.log(2.0)) * (g * o),),
    "exp10": _expands(lambda x: BinOp("pow", _k(10.0), x)),
    "expm1": _times(lambda x, o: o + _ONE),
    "log": lambda g, o, x: (g / x,),
    # jnp: log(x) / log(2), log(x) / log(10)
    "log2": lambda g, o, x: ((g / _k(math.log(2.0))) / x,),
    "log10": lambda g, o, x: ((g / _k(math.log(10.0))) / x,),
    "log1p": lambda g, o, x: (g / (x + _ONE),),
    "pow": _pow, "powr": _pow, "pown": _pow,
    "sqrt": _times(lambda x, o: _k(0.5) / o),
    "rsqrt": _times(lambda x, o: _k(-0.5) * (o / x)),
    # lax.cbrt: 1/3 ans^-2
    "cbrt": _times(lambda x, o: _k(1.0 / 3.0) * (_ONE / (o * o))),
    "rootn": _expands(lambda x, n: sign(x) * BinOp("pow", _B["fabs"](x),
                                                   _ONE / n)),
    "hypot": lambda g, o, a, b: (g * (a / o), g * (b / o)),
    **dict.fromkeys(("logb", "ceil", "floor", "trunc", "round", "rint",
                     "nearbyint", "sign", "step", "imag", "nan"), _zero),
    "fabs": _abs_rule, "abs": _abs_rule,
    # lax.rem: 1 and -sign(x/y) floor|x/y|
    "fmod": lambda g, o, a, b: (g, -(g * (sign(a / b) * _B["floor"](
        _B["fabs"](a / b))))),
    "remainder": _expands(lambda x, y: x - _B["rint"](x / y) * y),
    "copysign": _expands(lambda a, b: Where(
        _B["signbit"](b), -_B["fabs"](a), _B["fabs"](a))),
    "nextafter": "JAX defines no derivative of nextafter",
    "fdim": _expands(lambda a, b: _B["fmax"](a - b, _k(0.0))),
    "abs_diff": _expands(lambda a, b: _B["fabs"](a - b)),
    **dict.fromkeys(("fmin", "fmax", "min", "max"), _extreme),
    # jnp.clip: maximum(lo, x), then minimum(hi, that)
    "clamp": _expands(lambda x, lo, hi: _B["fmin"](hi, _B["fmax"](lo, x))),
    "mix": _expands(lambda x, y, a: x + (y - x) * a),
    "smoothstep": _expands(_smoothstep_tree),
    "maxmag": _expands(lambda a, b: Where(_B["fabs"](a) >= _B["fabs"](b),
                                          a, b)),
    "minmag": _expands(lambda a, b: Where(_B["fabs"](a) <= _B["fabs"](b),
                                          a, b)),
    **dict.fromkeys(("mad", "fma", "mad24"),
                    _expands(lambda a, b, c: a * b + c)),
    "mul24": _expands(lambda a, b: a * b),
    "erf": lambda g, o, x: (_k(_SQRT_PI_2) * (g * _B["exp"](-(x * x))),),
    "erfc": lambda g, o, x: (_k(-_SQRT_PI_2) * (g * _B["exp"](-(x * x))),),
    "lgamma": _times(lambda x, o: DIGAMMA(x)),
    "tgamma": _expands(lambda x: Where(
        x > _k(0.0), _B["exp"](_B["lgamma"](x)),
        _PI / (_B["sin"](_PI * x) * _B["exp"](_B["lgamma"](_ONE - x))))),
    "degrees": _times(lambda x, o: _k(180.0 / math.pi)),
    "radians": _times(lambda x, o: _k(math.pi / 180.0)),
    # jnp.ldexp: x1 itself at 0 and the infinities, else m 2^e of frexp
    "ldexp": lambda g, o, x, n: (Where(_B["isinf"](x) | (x == _k(0.0)), g,
                                       _B["ldexp"](g, n)), None),
    "select": _expands(lambda a, b, c: Where(c, b, a)),
    "real": lambda g, o, x: (g,),
    "conj": lambda g, o, x: (g,),
    "fract": _expands(lambda x: _B["fmin"](x - _B["floor"](x),
                                           ONE_BELOW(x))),
    # jnp.frexp's custom jvp: the mantissa's derivative is 2^-e
    "frexp_mant": lambda g, o, x: (_B["ldexp"](g, -_B["frexp_exp"](x)),),
    "digamma": "its derivative (trigamma) has no kernel form",
    "one_below": _zero,
}
