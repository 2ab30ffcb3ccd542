"""Expression evaluation: assignment into tensors through one kernel.

Port of ``vexcl_tpu/expr/compile.py`` (vexcl/operations.hpp
``assign_expression`` :1818-1909, ``assign_multiexpression``
:2081-2185).  One evaluation:

1. ``analyze`` gives the signature and the leaves; the type of every
   node (``infer_types``) is taken where something reads it;
2. where that walk met a node that reads other indices than its own
   (the SpMV, the stencils), ``hoist`` runs each such node first, into a
   temporary, as an array leaf, so ``x[:] = A * x`` never overwrites an
   element another thread still reads (the ``"hw"`` generator runs its
   Philox kernel here and comes back as an elementwise node over the
   words it wrote), and the hoisted trees are analysed again.  A tree
   that is one such node, assigned to a target of its type and length
   that it does not read, is materialized straight into the target;
3. ``triton_emit.assign`` launches the generated kernel (CUDA) or the
   plain PyTorch form (CPU), writing the destination in place.

``evaluate_multi`` does the same for k expressions written to k targets
(``tie``, ``multivector``, the symbolic generator's kernels): one hoist
over all of them, one analysis of their union (a node they share is one
node of the kernel) and one launch of ``triton_emit.assign_multi``.

Views (``expr/view.py``) read their inner expression over its own length:
``hoist`` materializes a non-elementwise node beneath a view at that
length, and a leaf beneath a view may have any length the view reads.
A target whose storage is read beneath a view (``x[:] =
permutation(p)(x)``, a transpose into itself) would be written by one
program while another still reads it, so such an assignment goes
through a temporary, as does a value that reads the vector it is
assigned into through a view (``assign_to_view``, V3: ``x[1:] =
x[:-1]``); the JAX package reads the old values in both.

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
from .node import (Analysis, ArrayTerminal, BinOp, CastExpr, Expr,
                   LazyTypes, UnOp, VectorTerminal, analyze, as_expr,
                   expression_properties)
from .triton_emit import assign, assign_multi
from .triton_emit import assign_to_view as assign_to_view_kernel

__all__ = ["ASSIGN_OPS", "evaluate", "evaluate_multi", "assign_value",
           "assign_to_view", "prepare_view_assign", "eval_expr", "hoist",
           "prepare", "prepare_multi"]

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
        kids = [hoist(c, device, m, memo)
                for c, m in zip(expr.children, expr.child_sizes(n))]
        changed = any(k is not c for k, c in zip(kids, expr.children))
        out = expr.with_children(kids) if changed else expr
    else:
        out = expr
    memo[id(expr)] = out
    return out


#: sizes below this take 32-bit index arithmetic (a block's margin kept)
_INDEX32 = (1 << 31) - (1 << 16)


def _reach(exprs: Sequence[Expr], analysis: Analysis, n: Optional[int]):
    """Walk the trees of a kernel with views over the number of elements
    each node is evaluated over: (the lengths each tensor leaf is read
    over, by slot; the slots read beneath a view, at indices other than
    the element's own; the largest length reached).  A view's length must
    be its context's, or 1 (it broadcasts)."""
    from .view import _View

    need: Dict[int, set] = {}
    gathered = set()
    top = n or 0
    seen = set()
    stack = [(e, n, False) for e in exprs]
    while stack:
        node, m, under = stack.pop()
        key = (id(node), m, under)
        if key in seen:
            continue
        seen.add(key)
        view = isinstance(node, _View)
        if view and m is not None and node.size_hint() not in (m, 1, None):
            raise ValueError(f"view of {node.size_hint()} elements in an "
                             f"expression of size {m}")
        slot = analysis.slot_of.get(id(node))
        if slot is not None:
            need.setdefault(slot, set()).add(m)
            if under:
                gathered.add(slot)
        for i, (c, cm) in enumerate(zip(node.children,
                                        node.child_sizes(m))):
            top = max(top, cm or 0)
            # a permutation's index (an image's coordinates) is read at
            # the element's own index
            own = not view or i in node.own_children
            stack.append((c, cm, under or not own))
    return need, gathered, top


def _check_leaves(exprs: Sequence[Expr], analysis: Analysis,
                  n: Optional[int], device: torch.device):
    """Validate the leaves: 1-D tensors on ``device`` of the length they
    are read over, n outside any view (VEXCL_CHECK_SIZES for vectors,
    operations.hpp:1442-1458)."""
    if config.check_sizes >= 2 and n is not None:
        for sz in analysis.elementwise_sizes:
            if sz != n:
                raise ValueError(
                    f"expression size mismatch: vector of size {sz} in "
                    f"expression assigned to size {n} "
                    "(set config.check_sizes=0 to disable)")
    need = None
    if analysis.indexed:
        need, gathered, top = _reach(exprs, analysis, n)
        analysis.gathered = frozenset(gathered)
        analysis.index_bits = 32 if top < _INDEX32 else 64
    leaves = []
    for slot, leaf in enumerate(analysis.leaves):
        if isinstance(leaf, torch.Tensor) and leaf.ndim == 0:
            leaf = _scalar_leaf(leaf, device)
            # the kernel's source and key follow what crosses: a CPU
            # tensor's value is a scalar parameter of the kernel
            analysis.leaves[slot] = leaf
            leaves.append(leaf)
            continue
        if isinstance(leaf, torch.Tensor):
            if leaf.device != device:
                if leaf.device.type != "cpu":
                    raise ValueError(f"expression leaf on {leaf.device}, "
                                     f"evaluation on {device}")
                leaf = leaf.to(device)
            wants = need.get(slot, ()) if need is not None else (n,)
            if leaf.ndim != 1 or any(w is not None and leaf.shape[0] != w
                                     for w in wants):
                raise ValueError(
                    f"array leaf of shape {tuple(leaf.shape)} in an "
                    f"expression of size {sorted(w for w in wants if w)}")
            leaf = leaf.contiguous()
        leaves.append(leaf)
    return leaves


def _scalar_leaf(leaf: torch.Tensor, device: torch.device):
    """A 0-d tensor leaf, a scalar of its own (strong) type: kept as it is
    on the evaluation's device (the kernel loads it once and broadcasts
    it, so a CUDA value is never read on the host); a CPU one in a CUDA
    evaluation crosses as a numpy scalar of its type, or as a copy where
    numpy has no such type (bf16)."""
    if leaf.device == device:
        return leaf
    if leaf.device.type != "cpu":
        raise ValueError(f"expression leaf on {leaf.device}, evaluation on "
                         f"{device}")
    if leaf.dtype == torch.bfloat16:
        return leaf.to(device)
    return leaf.numpy()[()]


def fit_index_bits(analysis: Analysis, size: int) -> None:
    """Widen a kernel's index arithmetic for a kernel of its own (V2, V3)
    that computes indices over ``size`` elements: 32 bits where the views
    of its tree allow it and ``size`` fits."""
    if size >= _INDEX32:
        analysis.index_bits = 64
    elif not analysis.indexed:
        analysis.index_bits = 32


def _storages(ts) -> set:
    return {t.untyped_storage().data_ptr() for t in ts
            if isinstance(t, torch.Tensor)}


def _gathers_target(analysis: Analysis, leaves,
                    outs: Sequence[torch.Tensor]) -> bool:
    """True when a target's storage is read beneath a view."""
    if not analysis.gathered:
        return False
    return bool(_storages([leaves[s] for s in analysis.gathered])
                & _storages(outs))


def prepare_multi(exprs: Sequence[Any], n: Optional[int],
                  device: torch.device):
    """Hoist, analyse and type several expressions together: (exprs,
    analysis, types, leaves on ``device``); a node they share is hoisted
    and analysed once.  One walk analyses the trees; only where it meets a
    node that runs its own kernel first are they hoisted and walked
    again.  The types are inferred at their first lookup (``LazyTypes``):
    a launch of a kernel built already reads none."""
    exprs = [as_expr(e) for e in exprs]
    analysis = analyze(*exprs)
    if analysis.hoist:
        memo: Dict[int, Expr] = {}
        exprs = [hoist(e, device, n, memo) for e in exprs]
        analysis = analyze(*exprs)
    return (exprs, analysis, LazyTypes(*exprs),
            _check_leaves(exprs, analysis, n, device))


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


def _writes_into(expr: Expr, n: int, out: torch.Tensor) -> bool:
    """True when ``expr`` is one node that runs its own kernel and can
    write its value straight into ``out`` (``Ap[:] = A * p``): out has
    its type and length, and none of its inputs is out's memory
    (``x[:] = A * x`` goes through a temporary)."""
    direct = expr.direct_dtype
    return (direct is not None and out.shape[0] == n
            and direct() == out.dtype
            and not _storages(analyze(expr).leaves) & _storages([out]))


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
        if combine is None and _writes_into(expr, n, out):
            expr.materialize(device, n, out=out)
            return out
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
    elif _gathers_target(analysis, leaves, [out]):
        tmp = torch.empty_like(out)
        assign(expr, analysis, types, leaves, tmp)
        out.copy_(tmp)
        return out
    assign(expr, analysis, types, leaves, out)
    return out


def assign_value(vec, value, op: str = "=") -> None:
    """Drive an assignment onto a vector container (in place).  The
    transform of a vector into a whole vector (``y[:] = FFT(n)(x)``) goes
    straight to its plan, with no expression analysis."""
    from ..ops.fft import FFTExpr

    if op == "=" and isinstance(value, FFTExpr) and value.into_vector(vec):
        return
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
    elif _gathers_target(analysis, leaves, outs):
        tmps = [torch.empty_like(o) for o in outs]
        assign_multi(exprs, analysis, types, leaves, tmps)
        for o, t in zip(outs, tmps):
            o.copy_(t)
        return tuple(outs)
    assign_multi(exprs, analysis, types, leaves, outs)
    return tuple(outs)


def prepare_view_assign(view: Expr, value: Any, op: str = "=",
                        atomic: Optional[str] = None):
    """The arguments of the view-assignment kernel (V3) that writes
    ``value`` through ``view``: (value, target view, analysis, types,
    leaves, the vector's storage, mode, n).  The value runs over the
    view's length, cast to the vector's type (as ``.at[idx]`` casts it),
    and is stored at the view's indices; a permutation's negative indices
    wrap and the rest out of range are dropped.  A compound op gathers the
    old value through the view (unique indices), except ``+=`` and ``*=``
    on a permutation, which update atomically so that repeated indices
    accumulate; ``atomic`` ("add", "sub", "min", "max") is the atomic
    update of ``ops/atomic.py``.  A value that reads the vector is
    evaluated into a temporary first."""
    from .view import PermutationView, _View

    if not isinstance(view, _View) or not isinstance(view.children[0],
                                                     VectorTerminal):
        raise TypeError("can only assign into a view of a vector")
    out = view.children[0].vec.storage
    n = view.size_hint()
    if n is None:
        raise ValueError("a view target needs a sized index")
    device = out.device
    value = as_expr(value)
    if _storages(analyze(value).leaves) & _storages([out]):
        value = ArrayTerminal(evaluate(value, n=n, device=device))
    val = CastExpr(out.dtype, value)
    perm = isinstance(view, PermutationView)
    if atomic is not None:
        mode = "add" if atomic == "sub" else atomic
        if atomic == "sub":
            val = UnOp("neg", val)
    elif op not in ASSIGN_OPS:
        raise ValueError(f"unsupported view assignment op {op!r}")
    elif op == "=":
        mode = "store"
    elif perm and op in ("+=", "*="):
        mode = "add" if op == "+=" else "mul"
    else:
        val, mode = BinOp(ASSIGN_OPS[op], view, val), "store"
    exprs, analysis, types, leaves = prepare_multi(
        [val, *view.children[1:]], n, device)
    fit_index_bits(analysis, max(n, out.numel()))
    target = view.with_children((view.children[0], *exprs[1:]))
    return exprs[0], target, analysis, types, leaves, out, mode, n


def assign_to_view(view: Expr, value: Any, op: str = "=",
                   atomic: Optional[str] = None) -> None:
    """Write ``value`` through ``view`` into the vector it views (V3,
    ``vexcl_tpu/expr/view.py:66-100``, ``ops/atomic.py:57-124``; see
    ``prepare_view_assign``): one launch of the view-assignment kernel."""
    assign_to_view_kernel(*prepare_view_assign(view, value, op, atomic))


def eval_expr(expr: Any) -> torch.Tensor:
    """vex::eval(expr) (eval.hpp:38-110): evaluate without assigning to a
    container; returns the computed tensor (an atomic update is applied,
    and returns its vector)."""
    if hasattr(expr, "execute"):
        return expr.execute()
    return evaluate(as_expr(expr))
