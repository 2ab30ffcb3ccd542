"""Expression evaluation: assignment into tensors through one kernel.

Port of ``vexcl_tpu/expr/compile.py`` (vexcl/operations.hpp
``assign_expression`` :1818-1909, ``assign_multiexpression``
:2081-2185).  One evaluation:

1. ``hoist``: nodes that read other indices than their own (the SpMV,
   the stencils) run first, each into a temporary, and become array
   leaves, so ``x[:] = A * x`` never overwrites an element another
   thread still reads; the ``"hw"`` generator runs its Philox kernel
   here and comes back as an elementwise node over the words it wrote;
2. ``analyze`` gives the signature and the leaves, ``infer_types`` the
   type of every node;
3. ``triton_emit.assign`` launches the generated kernel (CUDA) or the
   plain PyTorch form (CPU), writing the destination in place.

``evaluate_multi`` does the same for k expressions written to k targets
(``tie``, ``multivector``, the symbolic generator's kernels): one hoist
over all of them, one analysis of their union (a node they share is one
node of the kernel) and one launch of ``triton_emit.assign_multi``.

A compound assignment ``x += e`` is the plain assignment of
``BinOp("add", x, e)``: the old value is the destination's own leaf, as
the JAX package's ``old + new`` with ``old`` strongly typed.

Dropped from the JAX package: jit and its evaluator cache (the kernel
cache is in ``triton_emit``), sharding and placement signatures
(compile.py:289-312), scalar and table commits to device sets, and buffer
donation (compile.py:360-383), which becomes the plain in-place write;
``evaluate_multi``'s ``leaf_transform`` is ``events._moved``, applied by
``enqueue`` before the call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import config
from ..types import dtype_of, dtype_of_code
from .node import (Analysis, ArrayTerminal, BinOp, Expr, VectorTerminal,
                   analyze, as_expr, expression_properties, infer_types)
from .triton_emit import assign, assign_multi

__all__ = ["ASSIGN_OPS", "evaluate", "evaluate_multi", "assign_value",
           "eval_expr", "hoist", "prepare", "prepare_multi"]

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


def hoist(expr: Expr, device: torch.device, n: Optional[int] = None,
          memo: Optional[Dict[int, Expr]] = None) -> Expr:
    """Replace every non-elementwise node by what its own kernel computes
    for the n elements of the assignment: an array leaf holding its value,
    or (the ``"hw"`` generator) an elementwise node over the array leaves
    its kernel wrote."""
    memo = {} if memo is None else memo
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if not expr._elementwise:
        out = expr.materialize(device, n)
        if not isinstance(out, Expr):
            out = ArrayTerminal(out)
    elif expr.children:
        kids = [hoist(c, device, n, memo) for c in expr.children]
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


def prepare_multi(exprs: Sequence[Any], n: Optional[int],
                  device: torch.device):
    """Hoist, analyse and type several expressions together: (exprs,
    analysis, types, leaves on ``device``); a node they share is hoisted
    and analysed once."""
    memo: Dict[int, Expr] = {}
    exprs = [hoist(as_expr(e), device, n, memo) for e in exprs]
    analysis = analyze(*exprs)
    types = infer_types(*exprs)
    return exprs, analysis, types, _check_leaves(analysis, n, device)


def prepare(expr: Any, n: Optional[int], device: torch.device):
    """Hoist, analyse and type an expression: (expr, analysis, types,
    leaves on ``device``)."""
    (expr,), analysis, types, leaves = prepare_multi([expr], n, device)
    return expr, analysis, types, leaves


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


def evaluate_multi(exprs: Sequence[Any],
                   outs: Optional[Sequence[torch.Tensor]] = None,
                   ops: Optional[Sequence[str]] = None, *,
                   n: Optional[int] = None,
                   out_dtypes: Optional[Sequence[Any]] = None,
                   device: Optional[torch.device] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Fused evaluation of k expressions in ONE kernel
    (``vexcl_tpu/expr/compile.py::evaluate_multi``): into ``outs`` in
    place (one length, one device), each combined with its old value by
    its op of ``ops`` (default ``=``); or, without ``outs``, into k new
    tensors of ``n`` elements on ``device`` (default: the first
    expression's context's), typed ``out_dtypes`` or by inference."""
    exprs: List[Expr] = [as_expr(e) for e in exprs]
    ops = list(ops) if ops is not None else ["="] * len(exprs)
    if len(ops) != len(exprs) or (outs is not None
                                  and len(outs) != len(exprs)):
        raise ValueError("evaluate_multi: one op and one target per "
                         "expression")
    if outs is not None:
        n, device = outs[0].shape[0], outs[0].device
        if any(o.shape[0] != n or o.device != device for o in outs):
            raise ValueError("the targets of one fused assignment have one "
                             "length and one device")
        exprs = [e if ASSIGN_OPS[op] is None else
                 BinOp(ASSIGN_OPS[op], ArrayTerminal(o), e)
                 for e, o, op in zip(exprs, outs, ops)]
    else:
        if any(ASSIGN_OPS[op] is not None for op in ops):
            raise ValueError("compound ops need destination tensors")
        if n is None:
            n = next((e.size_hint() for e in exprs
                      if e.size_hint() is not None), None)
        if n is None:
            raise ValueError("expressions have no size: include a vector or "
                             "give n")
        device = device or _device_of(exprs[0])
    exprs, analysis, types, leaves = prepare_multi(exprs, n, device)
    if outs is None:
        dts = out_dtypes or [None] * len(exprs)
        outs = [torch.empty(n, device=device, dtype=dtype_of(dt)
                            if dt is not None
                            else dtype_of_code(types[id(e)]))
                for e, dt in zip(exprs, dts)]
    assign_multi(exprs, analysis, types, leaves, outs)
    return tuple(outs)


def eval_expr(expr: Any) -> torch.Tensor:
    """vex::eval(expr) (eval.hpp:38-110): evaluate without assigning to a
    container; returns the computed tensor."""
    return evaluate(as_expr(expr))
