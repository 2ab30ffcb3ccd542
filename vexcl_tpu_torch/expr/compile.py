"""Expression evaluation: assignment into a tensor through one kernel.

Port of ``vexcl_tpu/expr/compile.py`` (vexcl/operations.hpp
``assign_expression`` :1818-1909).  One evaluation:

1. ``hoist``: nodes that read other indices than their own (the SpMV) run
   first, each into a temporary, and become array leaves, so
   ``x[:] = A * x`` never overwrites an element another thread still
   reads;
2. ``analyze`` gives the signature and the leaves, ``infer_types`` the
   type of every node;
3. ``triton_emit.assign`` launches the generated kernel (CUDA) or the
   plain PyTorch form (CPU), writing the destination in place.

A compound assignment ``x += e`` is the plain assignment of
``BinOp("add", x, e)``: the old value is the destination's own leaf, as
the JAX package's ``old + new`` with ``old`` strongly typed.

Dropped from the JAX package: jit and its evaluator cache (the kernel
cache is in ``triton_emit``), sharding and placement signatures
(compile.py:289-312), scalar and table commits to device sets, and buffer
donation (compile.py:360-383), which becomes the plain in-place write.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import config
from ..types import dtype_of, dtype_of_code
from .node import (Analysis, ArrayTerminal, BinOp, Expr, VectorTerminal,
                   analyze, as_expr, expression_properties, infer_types)
from .triton_emit import assign

__all__ = ["ASSIGN_OPS", "evaluate", "assign_value", "eval_expr", "hoist",
           "prepare"]

# Assignment operator table (vexcl/operations.hpp:63-96): op -> the
# operator combining the old value with the new one.
ASSIGN_OPS = {
    "=": None,
    "+=": "add",
    "-=": "sub",
    "*=": "mul",
    "/=": "div",
    "%=": "mod",
    "&=": "bitand",
    "|=": "bitor",
    "^=": "bitxor",
    "<<=": "shl",
    ">>=": "shr",
}


def hoist(expr: Expr, device: torch.device,
          memo: Optional[Dict[int, Expr]] = None) -> Expr:
    """Replace every non-elementwise node by an array leaf holding its
    value (computed by that node's own kernel)."""
    memo = {} if memo is None else memo
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if not expr._elementwise:
        out = ArrayTerminal(expr.materialize(device))
    elif expr.children:
        kids = [hoist(c, device, memo) for c in expr.children]
        changed = any(k is not c for k, c in zip(kids, expr.children))
        out = expr.with_children(kids) if changed else expr
    else:
        out = expr
    memo[id(expr)] = out
    return out


def _check_leaves(analysis: Analysis, n: Optional[int],
                  device: torch.device):
    """Validate the leaves: 1-D length-n tensors on ``device``
    (VEXCL_CHECK_SIZES for vectors, operations.hpp:1442-1458)."""
    if config.check_sizes >= 2 and n is not None:
        for sz in analysis.elementwise_sizes:
            if sz != n:
                raise ValueError(
                    f"expression size mismatch: vector of size {sz} in "
                    f"expression assigned to size {n} "
                    "(set config.check_sizes=0 to disable)")
    leaves = []
    for leaf in analysis.leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.device != device:
                if leaf.device.type != "cpu":
                    raise ValueError(f"expression leaf on {leaf.device}, "
                                     f"evaluation on {device}")
                leaf = leaf.to(device)
            if leaf.ndim != 1 or (n is not None and leaf.shape[0] != n):
                raise ValueError(f"array leaf of shape {tuple(leaf.shape)} "
                                 f"in an expression of size {n}")
            leaf = leaf.contiguous()
        leaves.append(leaf)
    return leaves


def prepare(expr: Any, n: Optional[int], device: torch.device):
    """Hoist, analyse and type an expression: (expr, analysis, types,
    leaves on ``device``)."""
    expr = hoist(as_expr(expr), device)
    analysis = analyze(expr)
    types = infer_types(expr)
    return expr, analysis, types, _check_leaves(analysis, n, device)


def _device_of(expr: Expr) -> torch.device:
    _, ctx = expression_properties(expr)
    if ctx is not None:
        return ctx.device
    from ..context import current_context

    return current_context().device


def evaluate(expr: Any, n: Optional[int] = None, op: str = "=",
             out: Optional[torch.Tensor] = None, out_dtype=None,
             device: Optional[torch.device] = None):
    """Evaluate one expression into ``out`` (in place) or into a new
    tensor on ``device`` (default: the expression's context's),
    combining with ``out``'s old value for compound ops."""
    expr = as_expr(expr)
    combine = ASSIGN_OPS[op]
    if combine is not None:
        if out is None:
            raise ValueError(f"{op} needs a destination tensor")
        expr = BinOp(combine, ArrayTerminal(out), expr)
    if out is not None:
        n = out.shape[0] if n is None else n
        device = out.device
    else:
        if n is None:
            n = expr.size_hint()
        if n is None:
            raise ValueError("expression has no size: include a vector or "
                             "give element_index an explicit length")
        device = device or _device_of(expr)
    expr, analysis, types, leaves = prepare(expr, n, device)
    if out is None:
        dt = (dtype_of(out_dtype) if out_dtype is not None
              else dtype_of_code(types[id(expr)]))
        out = torch.empty(n, dtype=dt, device=device)
    assign(expr, analysis, types, leaves, out)
    return out


def assign_value(vec, value, op: str = "=") -> None:
    """Drive an assignment onto a vector container (in place)."""
    if ASSIGN_OPS[op] is not None:
        value = BinOp(ASSIGN_OPS[op], VectorTerminal(vec), as_expr(value))
    evaluate(value, n=vec.size, out=vec.storage)


def eval_expr(expr: Any) -> torch.Tensor:
    """vex::eval(expr) (eval.hpp:38-110): evaluate without assigning to a
    container; returns the computed tensor."""
    return evaluate(as_expr(expr))
