"""multivector<T,N> and vex::tie — fused multi-expression assignment.

Port of ``vexcl_tpu/multivector.py`` (vexcl/multivector.hpp:120-565, the
multiexpression machinery of operations.hpp:2081-2185, tie :2251).  N
equally sized components are one SoA container; assigning a multivector
expression, or a tuple of expressions to ``tie(x, y, ...)``, evaluates
ALL components in one generated kernel (``expr.compile.evaluate_multi``,
``triton_emit.assign_multi``), which reads each leaf once and loads every
old value before it stores any: ``tie(x, y)[:] = (y, x)`` swaps.

``multivector(data=a)`` takes a (k, n) array (numpy, list or tensor), one
row a component, which is how a JAX package multivector's state
(``to_numpy()``) crosses over; a 1-D array with ``m > 1`` is cut into m
rows, as the JAX package does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .context import Context, current_context
from .expr.compile import evaluate_multi
from .expr.node import Expr, as_expr
from .types import dtype_of
from .vector import host_tensor, vector

__all__ = ["multivector", "MultiExpr", "tie", "parts", "lift"]


class MultiExpr:
    """Tuple of per-component expression trees."""

    _multi = True

    def __init__(self, components: Sequence[Expr]):
        self.components = tuple(components)

    @property
    def nparts(self) -> int:
        return len(self.components)

    def _zip(self, other, fn):
        if getattr(other, "_multi", False):
            oc = parts(other)
            if len(oc) != len(self.components):
                raise ValueError("multivector component count mismatch")
            return MultiExpr([fn(a, b) for a, b in zip(self.components, oc)])
        o = as_expr(other)
        return MultiExpr([fn(a, o) for a in self.components])

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._zip(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._zip(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._zip(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._zip(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._zip(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._zip(o, lambda a, b: a ** b)

    def __neg__(self):
        return MultiExpr([-a for a in self.components])


def parts(x) -> List[Expr]:
    """The component expressions of a ``MultiExpr`` or a ``multivector``."""
    if isinstance(x, multivector):
        return [c._as_terminal() for c in x.components]
    return list(x.components)


def lift(fn, args) -> MultiExpr:
    """``fn`` applied componentwise over the multivector and ``MultiExpr``
    arguments of ``args`` (the others go to every component): builtins,
    user functions and ``make_temp`` over a multivector."""
    k = next(a.nparts for a in args if getattr(a, "_multi", False))
    comps = [parts(a) if getattr(a, "_multi", False) else None for a in args]
    if any(c is not None and len(c) != k for c in comps):
        raise ValueError("multivector component count mismatch")
    return MultiExpr([fn(*[a if c is None else c[i]
                           for a, c in zip(args, comps)])
                      for i in range(k)])


def _exprs_of(value: Any, k: int) -> List[Expr]:
    """k component expressions of an assigned value: a multivector, a
    ``MultiExpr``, a tuple or list of k expressions, or one expression or
    scalar for every component."""
    if getattr(value, "_multi", False):
        exprs = parts(value)
    elif isinstance(value, (tuple, list)):
        exprs = [as_expr(v) for v in value]
    else:
        exprs = [as_expr(value)] * k
    if len(exprs) != k:
        raise ValueError(f"{len(exprs)} expressions assigned to {k} "
                         "components")
    return exprs


def _assign(vectors: Sequence[vector], value: Any, op: str) -> None:
    evaluate_multi(_exprs_of(value, len(vectors)),
                   [v.storage for v in vectors], [op] * len(vectors))


class multivector:
    """N equally sized component vectors (multivector.hpp:120-565):
    ``multivector(n, m, dtype)``, ``multivector(data=a)`` with ``a`` of
    shape (m, n), or ``multivector(components=[...])``."""

    _multi = True

    def __init__(self, n: Optional[int] = None, m: int = 1, dtype: Any = None,
                 *, context: Optional[Context] = None, data: Any = None,
                 components: Optional[Sequence[vector]] = None) -> None:
        self.context = context or current_context()
        if components is not None:
            self._comps = list(components)
        elif data is not None:
            host = host_tensor(data)
            if host.ndim == 1:  # cut into m rows, as the reference ctor
                host = host.reshape(m, -1)
            self._comps = [vector(data=row, dtype=dtype, context=self.context)
                           for row in host]
        else:
            dt = dtype_of(dtype) if dtype is not None else torch.float32
            self._comps = [vector(n, dtype=dt, context=self.context)
                           for _ in range(m)]

    # -- component access (operator(), multivector.hpp:292) -----------------
    def __call__(self, i: int) -> vector:
        return self._comps[i]

    @property
    def components(self) -> Tuple[vector, ...]:
        return tuple(self._comps)

    @property
    def nparts(self) -> int:
        return len(self._comps)

    @property
    def size(self) -> int:
        return self._comps[0].size if self._comps else 0

    def __len__(self) -> int:
        return self.size

    @property
    def dtype(self) -> torch.dtype:
        return self._comps[0].dtype

    # -- element access: mv[j] -> tuple of scalars ---------------------------
    def __getitem__(self, j):
        if isinstance(j, (int, np.integer)):
            return tuple(c[int(j)] for c in self._comps)
        raise TypeError("multivector indexing takes an int element index")

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice) and key == slice(None):
            self.assign(value)
        elif isinstance(key, (int, np.integer)):
            for c, v in zip(self._comps, value):
                c[int(key)] = v
        else:
            raise TypeError("unsupported multivector assignment key")

    # -- expression protocol -------------------------------------------------
    def _as_multi(self) -> MultiExpr:
        return MultiExpr(parts(self))

    def __add__(self, o):
        return self._as_multi() + o

    def __radd__(self, o):
        return self._as_multi().__radd__(o)

    def __sub__(self, o):
        return self._as_multi() - o

    def __rsub__(self, o):
        return self._as_multi().__rsub__(o)

    def __mul__(self, o):
        return self._as_multi() * o

    def __rmul__(self, o):
        return self._as_multi().__rmul__(o)

    def __truediv__(self, o):
        return self._as_multi() / o

    def __rtruediv__(self, o):
        return self._as_multi().__rtruediv__(o)

    def __pow__(self, o):
        return self._as_multi() ** o

    def __neg__(self):
        return -self._as_multi()

    # -- fused assignment ----------------------------------------------------
    def assign(self, value: Any, op: str = "=") -> "multivector":
        _assign(self._comps, value, op)
        return self

    def __iadd__(self, o):
        return self.assign(o, "+=")

    def __isub__(self, o):
        return self.assign(o, "-=")

    def __imul__(self, o):
        return self.assign(o, "*=")

    def __itruediv__(self, o):
        return self.assign(o, "/=")

    def copy(self) -> "multivector":
        """Deep copy (multivector_create.cpp copy_constructor)."""
        return multivector(components=[c.copy() for c in self._comps],
                           context=self.context)

    def to_numpy(self) -> np.ndarray:
        return np.stack([c.to_numpy() for c in self._comps])

    def __repr__(self) -> str:
        return f"multivector<{self.dtype},{self.nparts}>[{self.size}]"


class _Tied:
    """Result of vex::tie(x, y, ...): assign a tuple of expressions in ONE
    fused kernel (operations.hpp:2230-2256)."""

    def __init__(self, vectors: Sequence[vector]):
        self.vectors = list(vectors)

    def assign(self, exprs: Any, op: str = "=") -> None:
        _assign(self.vectors, exprs, op)

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice) and key == slice(None):
            self.assign(value)
        else:
            raise TypeError("use tied[:] = (expr, ...)")


def tie(*vectors: vector) -> _Tied:
    return _Tied(vectors)
