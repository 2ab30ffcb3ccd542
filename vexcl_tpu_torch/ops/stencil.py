"""1-D stencil convolution and user-body stencil operators.

Port of ``vexcl_tpu/ops/stencil.py`` (vexcl/stencil.hpp:43-680: stencil
:168, exchange_halos :90-165, StencilOperator :510, VEX_STENCIL_OPERATOR
:673).  Usage is the JAX package's::

    s = vex.stencil([1/3, 1/3, 1/3], center=1)
    y[:] = x * s                                  # convolution
    y[:] = x * s + 2*x                            # inside an expression
    x[:] = x * s                                  # in place: reads old x

    op = vex.StencilOperator(width=3, center=1,
                             body=lambda X: X[0] + (X[-1] + X[1])**3)
    y[:] = op(x)

``x * s`` is a ``StencilExpr`` node.  Like the SpMV it reads other indices
than its own, so evaluation computes it first (its input expression, then
the stencil kernel of ``cuda_stencil.py``) into a temporary, and the
elementwise kernel reads that temporary as a leaf: ``x[:] = x * s`` is
in-place safe.  The taps keep numpy's type (f64 for Python floats), and
the value has the promoted type of x and taps, as ``jnp.result_type(x,
coeff)`` in the JAX package: f32 x with Python-float taps gives f64.
The constructor also takes a JAX package stencil's ``coeff`` and
``center`` as they are.

``StencilOperator`` has no kernel of its own, in either package: each
``X[k]`` is a leaf holding a shifted view of one edge-padded copy of the
input, the body builds an ordinary expression over those leaves, and the
expression kernel fuses it.  Its signature carries the body's identity.
The mesh-sharded forms wait for multi-device contexts.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..cache import fn_token
from ..expr.compile import evaluate
from ..expr.node import ArrayTerminal, EmitEnv, Expr, VectorTerminal, as_expr
from .cuda_stencil import stencil_apply

__all__ = ["stencil", "StencilExpr", "StencilOperator", "StencilOpExpr",
           "stencil_operator"]


def _input(node: Expr, device: torch.device) -> torch.Tensor:
    """The stencil's input as a tensor on ``device`` (an expression is
    evaluated first)."""
    xt = (node.vec.storage if isinstance(node, VectorTerminal)
          else evaluate(node, device=device))
    if xt.device != device:
        raise ValueError(f"stencil operand on {xt.device}, evaluation on "
                         f"{device}")
    return xt


class StencilExpr(Expr):
    """x * s as an expression node."""

    _opname = "stencil"
    _elementwise = False

    def __init__(self, st: "stencil", x: Any):
        self.st = st
        self.children = (as_expr(x),)

    def extra_sig(self) -> str:
        return f"{self.st.width}:{self.st.center}:{self.st.digest}"

    def materialize(self, device: torch.device) -> torch.Tensor:
        return stencil_apply(_input(self.children[0], device),
                             self.st.coeff_on(device), self.st.center)

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)

    def size_hint(self) -> Optional[int]:
        return self.children[0].size_hint()


class stencil:
    """vex::stencil<T>(queue, coefficients, center) (stencil.hpp:168)."""

    def __init__(self, coefficients: Sequence[float], center: int, *,
                 context=None):
        from ..vector import host_tensor

        c = np.asarray(coefficients)
        if c.ndim != 1 or not len(c):
            raise ValueError("stencil coefficients must be a non-empty 1-D "
                             "sequence")
        #: digest of the tap values, for the signature (the JAX package's)
        self.digest = hashlib.sha1(
            c.tobytes() + str(c.dtype).encode()).hexdigest()[:12]
        self.coeff = host_tensor(c)
        self.width = int(len(c))
        self.center = int(center)
        if not (0 <= self.center < self.width):
            raise ValueError("stencil center must lie inside the stencil")
        self._on: Dict[torch.device, torch.Tensor] = {}

    def coeff_on(self, device: torch.device) -> torch.Tensor:
        """The taps on ``device`` (copied there once)."""
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self.coeff.to(device).contiguous()
        return t

    def __rmul__(self, x) -> StencilExpr:  # y = x * s (reference idiom)
        return StencilExpr(self, x)

    def __mul__(self, x) -> StencilExpr:  # y = s * x also accepted
        return StencilExpr(self, x)

    def __call__(self, x) -> StencilExpr:
        return StencilExpr(self, x)


class _WindowAccessor:
    """X passed to user bodies: X[k] is the input shifted by k, a leaf
    over a view of the edge-padded copy (stencil.hpp:510-673)."""

    def __init__(self, padded: torch.Tensor, n: int, center: int):
        self._padded = padded
        self._n = n
        self._center = center
        self._leaves: Dict[int, ArrayTerminal] = {}

    def __getitem__(self, k: int) -> ArrayTerminal:
        k = int(k)
        leaf = self._leaves.get(k)
        if leaf is None:
            ofs = self._center + k
            if not 0 <= ofs <= self._padded.shape[0] - self._n:
                raise IndexError(f"X[{k}] lies outside the stencil")
            leaf = self._leaves[k] = ArrayTerminal(
                self._padded[ofs:ofs + self._n])
        return leaf


class StencilOpExpr(Expr):
    """op(x) as an expression node."""

    _opname = "stencil_op"
    _elementwise = False

    def __init__(self, op: "StencilOperator", x: Any):
        self.op = op
        self.children = (as_expr(x),)

    def extra_sig(self) -> str:
        # the body is a user callable: equal-named operators with other
        # bodies must not share a kernel
        return (f"{self.op.name}#{fn_token(self.op.body)}"
                f":{self.op.width}:{self.op.center}")

    def materialize(self, device: torch.device) -> torch.Tensor:
        x = _input(self.children[0], device)
        n = x.shape[0]
        lpad = self.op.center
        rpad = self.op.width - 1 - lpad
        if n == 0:  # every X[k] is empty
            padded = x.new_zeros(lpad + rpad)
        else:  # edge replication at the ends (exchange_halos :138-154)
            padded = torch.cat([x[:1].expand(lpad), x, x[-1:].expand(rpad)])
        body = as_expr(self.op.body(_WindowAccessor(padded, n, lpad)))
        return evaluate(body, n=n, device=device)

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)

    def size_hint(self) -> Optional[int]:
        return self.children[0].size_hint()


class StencilOperator:
    """User-body stencil (StencilOperator, stencil.hpp:510;
    VEX_STENCIL_OPERATOR :673).  ``body`` receives an accessor ``X`` with
    ``X[k]`` the input shifted by k in [-center, width-1-center]."""

    _counter = [0]

    def __init__(self, width: int, center: int, body: Callable,
                 name: str = "", *, context=None):
        self.width = int(width)
        self.center = int(center)
        if not (0 <= self.center < self.width):
            raise ValueError("stencil center must lie inside the stencil")
        self.body = body
        if not name:
            StencilOperator._counter[0] += 1
            name = f"sop{StencilOperator._counter[0]}"
        self.name = name

    def __call__(self, x) -> StencilOpExpr:
        return StencilOpExpr(self, x)


def stencil_operator(width: int, center: int, name: str = ""):
    """Decorator form of VEX_STENCIL_OPERATOR::

        @vex.stencil_operator(width=3, center=1)
        def op(X):
            return X[0] + (X[-1] + X[1]) ** 3
    """

    def wrap(fn: Callable) -> StencilOperator:
        return StencilOperator(width, center, fn, name or fn.__name__)

    return wrap
