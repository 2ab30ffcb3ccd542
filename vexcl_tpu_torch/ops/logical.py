"""any_of / all_of predicates over expressions.

Port of ``vexcl_tpu/ops/logical.py`` (vexcl/logical.hpp:47-181).  The
reference launches a one-workgroup sampling kernel hoping for an early
answer, then a full reduction; here each is one launch of the map-reduce
kernel (``ops/triton_reduce.py``): MAX (``any_of``) or MIN (``all_of``)
of ``expr != 0`` cast to i32, since the kernel reduces no booleans.  NaN
counts as true, as in ``jnp.any``.  Over the parts of partitioned vectors
it is the Reductor's per-part launch and combine (``reductor.
_reduce_parts``), with one transfer of the answer.
"""

from __future__ import annotations

from typing import Any

import torch

from ..expr.compile import prepare
from ..expr.node import BinOp, CastExpr, as_expr, expression_properties
from . import dispatch
from .triton_reduce import map_reduce

__all__ = ["any_of", "all_of"]


def _pred(expr: Any, kind: str) -> bool:
    expr = as_expr(expr)
    n, ctx = expression_properties(expr)
    if n is None:
        raise ValueError("any_of/all_of: the expression has no size")
    if n == 0:
        return kind == "MIN"        # any of nothing: False; all: True
    body = CastExpr(torch.int32, BinOp("ne", expr, as_expr(0)))
    ref = dispatch.partitioned(expr)
    if ref is not None:
        from .reductor import MAX, MIN, _reduce_parts

        return bool(_reduce_parts([body], [MAX if kind == "MAX" else MIN],
                                  ref)[0].item())
    if ctx is None:
        from ..context import current_context

        ctx = current_context()
    body, analysis, types, leaves = prepare(body, n, ctx.device)
    return bool(map_reduce(body, analysis, types, leaves, n, kind,
                           ctx.device).item())


def any_of(expr: Any) -> bool:
    return _pred(expr, "MAX")


def all_of(expr: Any) -> bool:
    return _pred(expr, "MIN")
