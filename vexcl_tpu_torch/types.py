"""Scalar type mapping and promotion.

Port of ``vexcl_tpu/types.py`` (vexcl/types.hpp: type_name<T>()).  Dtypes
are ``torch.dtype`` objects.  Promotion follows what the JAX package gets
from ``jnp`` with 64-bit types enabled, not PyTorch's own rules, so an
expression gives the same result type in both packages: ``2 * x`` stays
f32 for f32 ``x`` (a Python scalar is *weakly typed*), ``i32 / i32`` is
f32, and ``i32 * 2.0`` is f64.

A type is carried internally as a lattice code: ``"f32"``, ``"i64"``,
``"b1"`` ... for strong types and ``"i*"``, ``"f*"``, ``"c*"`` for the
weak types of Python ints, floats and complex numbers.  ``join`` is the
least upper bound on JAX's promotion lattice
(jax/_src/dtypes.py ``_type_promotion_lattice``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np
import torch

__all__ = ["dtype_of", "type_name", "promote", "is_floating", "is_integral",
           "is_complex", "scalar_of", "COMPLEX_CODES", "real_code",
           "to_float"]

_CODE_TO_DTYPE = {
    "b1": torch.bool,
    "u8": torch.uint8, "u16": torch.uint16, "u32": torch.uint32,
    "u64": torch.uint64,
    "i8": torch.int8, "i16": torch.int16, "i32": torch.int32,
    "i64": torch.int64,
    "bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
    "f64": torch.float64,
    "c64": torch.complex64, "c128": torch.complex128,
    # weak types take the widest member of their kind (64-bit mode)
    "i*": torch.int64, "f*": torch.float64, "c*": torch.complex128,
}
_DTYPE_TO_CODE = {v: k for k, v in _CODE_TO_DTYPE.items() if "*" not in k}

_LATTICE = {
    "b1": ("i*",),
    "u8": ("i16", "u16"), "u16": ("i32", "u32"), "u32": ("i64", "u64"),
    "u64": ("f*",),
    "i*": ("u8", "i8"), "i8": ("i16",), "i16": ("i32",), "i32": ("i64",),
    "i64": ("f*",),
    "f*": ("c*", "f16", "bf16"), "bf16": ("f32",), "f16": ("f32",),
    "f32": ("f64", "c64"), "f64": ("c128",),
    "c*": ("c64",), "c64": ("c128",), "c128": (),
}

#: jnp's promotion of an integer/bool type to an inexact one
#: (jax/_src/dtypes.py ``_dtype_to_inexact``).
_TO_INEXACT = {"b1": "f32", "i8": "f32", "i16": "f32", "i32": "f32",
               "u8": "f32", "u16": "f32", "u32": "f32", "i64": "f64",
               "u64": "f64", "i*": "f*"}

#: the complex codes and the code of their real and imaginary parts
#: (``jnp.real``, ``jnp.abs``: c64 -> f32, c128 -> f64, weak -> weak)
_REAL_OF = {"c64": "f32", "c128": "f64", "c*": "f*"}
COMPLEX_CODES = frozenset(_REAL_OF)

# Canonical name -> dtype table (types.hpp type_name specializations).
_NAMED_TYPES = {
    "bool": torch.bool, "char": torch.int8, "uchar": torch.uint8,
    "short": torch.int16, "ushort": torch.uint16, "int": torch.int32,
    "uint": torch.uint32, "long": torch.int64, "ulong": torch.uint64,
    "half": torch.float16, "bfloat16": torch.bfloat16,
    "float": torch.float32, "double": torch.float64,
    "cfloat": torch.complex64, "cdouble": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in _NAMED_TYPES.items()}


@lru_cache(maxsize=None)
def _upper(code: str) -> frozenset:
    out = {code}
    for nxt in _LATTICE[code]:
        out |= _upper(nxt)
    return frozenset(out)


@lru_cache(maxsize=None)
def join(a: str, b: str) -> str:
    """Least upper bound of two lattice codes."""
    common = _upper(a) & _upper(b)
    for c in common:
        if all(o in _upper(c) for o in common):
            return c
    raise TypeError(f"no common type for {a} and {b}")


def to_inexact(code: str) -> str:
    return _TO_INEXACT.get(code, code)


def to_float(code: str) -> str:
    """jnp's cast of an integer or boolean type to the default float type
    (f64 in 64-bit mode, strongly typed: ``jnp.rint`` of i32 is f64);
    float and complex codes as they are."""
    dt = _CODE_TO_DTYPE[code]
    return code if dt.is_floating_point or dt.is_complex else "f64"


def real_code(code: str) -> str:
    """The code of a complex code's parts; a real code as it is."""
    return _REAL_OF.get(code, code)


def code_of(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_TO_CODE[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype}") from None


def dtype_of_code(code: str) -> torch.dtype:
    return _CODE_TO_DTYPE[code]


def scalar_code(value: Any) -> str:
    """Lattice code of a host scalar: Python numbers are weak, numpy
    scalars keep their dtype."""
    if isinstance(value, (bool, np.bool_)):
        return "b1"
    if isinstance(value, np.generic):
        return code_of(dtype_of(value.dtype))
    if isinstance(value, int):
        return "i*"
    if isinstance(value, float):
        return "f*"
    if isinstance(value, complex):
        return "c*"
    raise TypeError(f"not a scalar: {value!r}")


def dtype_of(t: Any) -> torch.dtype:
    """Resolve a type designator (torch dtype, numpy dtype or type, or a
    name such as ``"float"``) to a ``torch.dtype``."""
    if isinstance(t, torch.dtype):
        return t
    if isinstance(t, str) and t in _NAMED_TYPES:
        return _NAMED_TYPES[t]
    dt = np.dtype(t)
    if dt.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def type_name(t: Any) -> str:
    """Device-source-level name of a scalar type (types.hpp type_name<T>)."""
    dt = dtype_of(t)
    return _DTYPE_NAMES.get(dt, str(dt).replace("torch.", ""))


def is_floating(t: Any) -> bool:
    return dtype_of(t).is_floating_point


def is_integral(t: Any) -> bool:
    dt = dtype_of(t)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def is_complex(t: Any) -> bool:
    return dtype_of(t).is_complex


def scalar_of(t: Any) -> torch.dtype:
    """Underlying real scalar of a type (cl_scalar_of analog)."""
    dt = dtype_of(t)
    return dt.to_real() if dt.is_complex else dt


def promote(*dtypes: Any) -> torch.dtype:
    """Common result type of strongly typed operands (deduce_value_type,
    vexcl/operations.hpp:1723-1796), by the JAX package's rules."""
    code = code_of(dtype_of(dtypes[0]))
    for d in dtypes[1:]:
        code = join(code, code_of(dtype_of(d)))
    return dtype_of_code(code)
