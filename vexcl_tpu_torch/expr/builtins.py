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
  ``real`` and ``imag`` of c64 are f32);
* the PyTorch form gets its operands already cast to the compute type
  and serves CPU tensors;
* the kernel form is the spelling in the generated Triton source, with
  ``{0}``, ``{1}`` ... for the operands (``triton_emit.py`` defines the
  few named forms such as ``"min"``).  ``libdevice`` is Triton's CUDA
  libdevice binding: ``tl.exp``, ``tl.sqrt`` and ``/`` lower to
  approximate PTX instructions in f32 on the installed Triton, so the
  kernel spells the correctly rounded libdevice functions.

On complex values the kernel covers ``real``, ``imag``, ``conj``,
``abs`` (the magnitude, ``libdevice.hypot``), ``sign`` (x/|x|) and the
rounding of each part (``round``, ``rint``, ``nearbyint``) as (re, im) pairs
(``triton_emit.Emitter.complex_op``); every other builtin of a complex
value raises ``NotImplementedError`` on CUDA and computes on the CPU.
A builtin whose kernel form is ``None`` computes on CPU tensors and raises
``NotImplementedError`` (with its name) on CUDA tensors.  Entries of the
JAX catalog that are not in this table are listed in ROADMAP.md.
Applied to plain numbers or tensors a builtin computes eagerly (the
VEX_DUAL_FUNCTOR behaviour, function.hpp:243): on tensors it returns a
tensor; on plain Python numbers a Python number, computed in f64 or i64
(``jnp`` keeps such a result weakly typed, so ``sin(2.0) + x`` has x's
type in both packages); applied to a multivector
or a multivector expression, it applies componentwise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .node import Expr, FuncCall, as_expr, fmod, sign

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

    def __call__(self, *args):
        if any(getattr(a, "_multi", False) for a in args):
            from ..multivector import lift

            return lift(self, args)
        if any(isinstance(a, Expr) or hasattr(a, "_as_terminal")
               for a in args):
            return FuncCall(self.name, self.entry, [as_expr(a) for a in args])
        if all(type(a) in _WEAK for a in args):
            # plain Python numbers: jnp computes them weakly typed (f64 in
            # 64-bit mode) and the result stays weak, so it comes back as a
            # Python number, which an expression takes as a weak scalar
            inexact = self.entry[0] in ("inexact", "float", "weak_inexact")
            vals = [torch.tensor(a, dtype=torch.float64 if inexact and type(
                a) in (bool, int) else _WEAK[type(a)]) for a in args]
            return self.entry[1](*vals).item()
        return self.entry[1](*[torch.as_tensor(a) for a in args])

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
    "sinpi": ("weak_inexact", lambda x: torch.sin(math.pi * x), None),
    "cospi": ("weak_inexact", lambda x: torch.cos(math.pi * x), None),
    "tanpi": ("weak_inexact", lambda x: torch.tan(math.pi * x), None),
    "asinpi": ("inexact", lambda x: torch.asin(x) / math.pi, None),
    "acospi": ("inexact", lambda x: torch.acos(x) / math.pi, None),
    "atanpi": ("inexact", lambda x: torch.atan(x) / math.pi, None),
    "atan2pi": ("inexact", lambda y, x: torch.atan2(y, x) / math.pi, None),
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
             None),
    # power / roots
    "pow": ("numeric", torch.pow, "pow"),
    "powr": ("numeric", torch.pow, "pow"),
    "pown": ("numeric", torch.pow, "pow"),
    "sqrt": ("inexact", torch.sqrt, _ld("sqrt_rn")),
    "rsqrt": ("inexact", torch.rsqrt, _ld("rsqrt")),
    "cbrt": ("inexact", lambda x: sign(x) * torch.abs(x) ** (1.0 / 3),
             _ld("cbrt")),
    "rootn": ("weak_inexact", _rootn, None),
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
    "remainder": ("inexact", lambda x, y: x - torch.round(x / y) * y, None),
    "copysign": ("inexact", torch.copysign, _ld("copysign", 2)),
    "nextafter": ("inexact", torch.nextafter, None),
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
    # fused / fast arithmetic
    "mad": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "fma": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "mad24": ("join", lambda a, b, c: a * b + c, "({0} * {1} + {2})"),
    "mul24": ("join", lambda a, b: a * b, "({0} * {1})"),
    # special functions
    "erf": ("inexact", torch.erf, _ld("erf")),
    "erfc": ("inexact", torch.erfc, _ld("erfc")),
    "lgamma": ("inexact", torch.lgamma, _ld("lgamma")),
    "tgamma": ("inexact", _tgamma, None),
    # classification
    "isnan": ("bool", torch.isnan, "({0} != {0})"),
    "isinf": ("bool", torch.isinf, "(tl.abs({0}) == float('inf'))"),
    "isfinite": ("bool", torch.isfinite, "(tl.abs({0}) < float('inf'))"),
    "isnormal": ("bool", lambda x: torch.isfinite(x) & (x != 0), None),
    "signbit": ("bool", torch.signbit, "(libdevice.signbit({0}) != 0)"),
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
    # conversions
    "degrees": ("inexact", torch.rad2deg, None),
    "radians": ("inexact", torch.deg2rad, None),
    # selection
    "select": ("join", lambda a, b, c: torch.where(c != 0, b, a), None),
    "bitselect": ("join", lambda a, b, c: (a & ~c) | (b & c),
                  "(({0} & ~{2}) | ({1} & {2}))"),
    # complex parts (jnp.real, jnp.imag, jnp.conj; a real value is its own
    # real part and conjugate, its imaginary part zeros of its type)
    "real": ("real", torch.real, "real"),
    "imag": ("real", _imag, "imag"),
    "conj": ("join", _conj, "conj"),
    # integer helpers
    "hadd": ("join", lambda a, b: (a & b) + ((a ^ b) >> 1),
             "(({0} & {1}) + (({0} ^ {1}) >> 1))"),
    "rhadd": ("join", lambda a, b: (a | b) - ((a ^ b) >> 1),
              "(({0} | {1}) - (({0} ^ {1}) >> 1))"),
}

BUILTINS = {name: builtin(name, entry) for name, entry in _CATALOG.items()}

globals().update(BUILTINS)
__all__ += list(BUILTINS)

#: builtins that have a spelling in the CUDA expression kernel
KERNEL_BUILTINS = tuple(n for n, e in _CATALOG.items() if e[2] is not None)
