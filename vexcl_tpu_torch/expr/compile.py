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

Several parts (vexcl/operations.hpp ``assign_expression`` loops over the
context's queues, each over its part).  An assignment into a vector of a
context of several parts (``assign_value``, ``assign_vectors``) runs in
three steps:

1. ``hoist_parts`` walks the trees once: every partitioned vector they
   read at the element's own index has the target's partition; a node
   that reads other indices and is written for parts
   (``materialize_parts``: the distributed SpMV, the stencils, the FFT,
   ``reduce_view``, ``tensordot``, MBA) runs first, over all parts, into
   a partitioned temporary; what a view reads beneath it is made whole on
   each distinct device (``gather_whole``: a partitioned vector gathered
   once a call); any other such node raises NotImplementedError naming
   itself (``ops/dispatch.py``);
2. each part gets its own trees (``part_trees``): an array leaf of the
   whole length is sliced to the part, ``element_index()`` becomes the
   part's local index plus its offset, a scalar leaf, so the index stays
   global (the counter-based generators count with it) while the kernel
   key stays the part's structure, and each view becomes the part's node
   (``_View.part_view``) over what it reads on the part's device
   (``on_device``: the gathered tensor there, a table's copy there);
   vectors are the part the evaluator binds (``dispatch.part``) and
   scalars are shared;
3. the one-part path runs on each part in turn, on the part's device:
   one launch of the generated assignment kernel (or K1 for k targets,
   or the gather forms) a part, through the one cached record of its key.

A write through a view into a partitioned vector (``assign_to_view``)
goes by owner (``_assign_to_view_parts``): every part that holds
elements runs the one-part scatter over all the updates, its own at
their index in the part, the rest dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..types import dtype_of, dtype_of_code
from .node import (Analysis, ArrayTerminal, BinOp, CastExpr, ElementIndex,
                   Expr, LazyTypes, ScalarTerminal, TaggedTerminal, UnOp,
                   VectorTerminal, analyze, as_expr, expression_properties,
                   infer_types)
from .triton_emit import assign, assign_multi
from .triton_emit import assign_to_view as assign_to_view_kernel

__all__ = ["ASSIGN_OPS", "evaluate", "evaluate_multi", "assign_value",
           "assign_vectors", "assign_to_view", "prepare_view_assign",
           "eval_expr", "hoist", "prepare", "prepare_multi", "hoist_parts",
           "part_trees", "evaluate_parts", "gather_whole", "on_device",
           "whole_on", "whole_parts", "Stages"]

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


class Stages:
    """The stages of one call of a kernel whose trees hold nodes that run
    their own kernel first (a staged backward): the value of each such
    node that ran, by (id, length), so that a node two stages read runs
    once; and whether they run their kernels' plain versions
    (``generator.Kernel.plain``).  ``prepare_multi`` and ``hoist`` pass it
    to the ``materialize`` of the nodes that take it (``takes_stages``:
    ``ReducedView``, ``adjoint.Stage``, ``adjoint.ViewAdjoint``)."""

    def __init__(self, plain: bool = False):
        self.plain = plain
        self.memo: Dict[tuple, tuple] = {}


def hoist(expr: Expr, device: torch.device, n: Optional[int] = None,
          memo: Optional[Dict[int, Expr]] = None,
          stages: Optional[Stages] = None) -> Expr:
    """Replace every non-elementwise node by what its own kernel computes
    for the n elements of the assignment: an array leaf holding its value,
    or (the ``"hw"`` generator) an elementwise node over the array leaves
    its kernel wrote.  With ``stages``, such a node runs once in them."""
    memo = {} if memo is None else memo
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if not expr._elementwise:
        kept = None if stages is None else stages.memo.get((id(expr), n))
        if kept is not None and kept[0] is expr:
            out = kept[1]
        else:
            out = (expr.materialize(device, n, stages=stages)
                   if stages is not None and expr.takes_stages
                   else expr.materialize(device, n))
            if not isinstance(out, Expr):
                out = ArrayTerminal(out)
            if stages is not None:
                stages.memo[(id(expr), n)] = (expr, out)
    elif expr.children:
        kids = [hoist(c, device, m, memo, stages)
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
        if view:
            top = max(top, node.reach)
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
                  device: torch.device, stages: Optional[Stages] = None):
    """Hoist, analyse and type several expressions together: (exprs,
    analysis, types, leaves on ``device``); a node they share is hoisted
    and analysed once.  One walk analyses the trees; only where it meets a
    node that runs its own kernel first are they hoisted and walked
    again.  The types are inferred at their first lookup (``LazyTypes``):
    a launch of a kernel built already reads none.  ``stages``: see
    ``hoist``."""
    exprs = [as_expr(e) for e in exprs]
    analysis = analyze(*exprs)
    if analysis.hoist:
        memo: Dict[int, Expr] = {}
        exprs = [hoist(e, device, n, memo, stages) for e in exprs]
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

    if vec._parts is not None:
        _assign_parts([vec], [value], [op])
        return
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
                   device: Optional[torch.device] = None,
                   stages: Optional[Stages] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Fused evaluation of k expressions in ONE kernel
    (``vexcl_tpu/expr/compile.py::evaluate_multi``): into ``outs`` in
    place (one length, one device), each combined with its old value by
    its op of ``ops`` (default ``=``); or, without ``outs``, into k new
    tensors of ``n`` elements on ``device`` (default: the first
    expression's context's), typed ``out_dtypes`` or by inference.
    ``stages``: see ``hoist``."""
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
    exprs, analysis, types, leaves = prepare_multi(exprs, n, device, stages)
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


def assign_vectors(vectors: Sequence[Any], values: Sequence[Any],
                   ops: Sequence[str]) -> None:
    """k values into k vectors of one length in one kernel (``tie``,
    ``multivector``): ``evaluate_multi`` into their storage, or part by
    part where they are partitioned."""
    if any(v._parts is not None for v in vectors):
        _assign_parts(vectors, values, ops)
    else:
        evaluate_multi(values, [v.storage for v in vectors], ops)


# -- several parts ------------------------------------------------------------

def _same_partition(vec, ref) -> None:
    if vec.nparts != ref.nparts or not np.array_equal(vec._pts, ref._pts):
        raise ValueError(
            f"a vector of {vec.size} elements in {vec.nparts} parts in an "
            f"expression over {ref.size} elements in {ref.nparts} parts")


class _Gathered(ArrayTerminal):
    """A partitioned vector read beneath a view, or the value of a node
    written for parts there: its whole value on each distinct device of
    the context (``halo.all_gather``)."""

    def __init__(self, wholes: Dict[torch.device, torch.Tensor]):
        self.wholes = wholes
        self.array = next(iter(wholes.values()))


def gather_whole(e: Expr, context, memo: Dict[int, Expr],
                 gathered: Dict[int, Dict]) -> Expr:
    """``e``, read at other indices than its own (beneath a view, or over
    every update of a scatter), with each partitioned vector it reads
    gathered whole onto each distinct device of ``context`` (once a vector
    a call, ``gathered``), and each node written for parts
    (``materialize_parts``) run first over the partition of its own
    length and gathered so.  The rest of the tree stays: the one-part
    path evaluates it on each device over the whole length
    (``on_device``)."""
    from ..ops.dispatch import Layout, partitioned
    from ..parallel.halo import all_gather

    hit = memo.get(id(e))
    if hit is not None:
        return hit
    devices = context.devices
    if isinstance(e, VectorTerminal) and e.vec.nparts > 1:
        w = gathered.get(id(e.vec))
        if w is None:
            w = gathered[id(e.vec)] = dict(zip(devices, all_gather(
                e.vec.parts, devices)))
        out = _Gathered(w)
    elif isinstance(e, TaggedTerminal):
        inner = gather_whole(e.inner, context, memo, gathered)
        out = e if inner is e.inner else TaggedTerminal(e.tag_id, inner)
    elif hasattr(e, "materialize_parts") and partitioned(e) is not None:
        v = e.materialize_parts(Layout(context, _sized_node(e)))
        out = _Gathered(dict(zip(devices, all_gather(v.parts, devices))))
    elif e.children:
        kids = [gather_whole(c, context, memo, gathered) for c in e.children]
        out = (e.with_children(kids) if any(
            k is not c for k, c in zip(kids, e.children)) else e)
    else:
        out = e
    memo[id(e)] = out
    return out


def _sized_node(e: Expr) -> int:
    n = e.size_hint()
    if n is None:
        raise ValueError(f"{type(e).__name__} over parts needs a size")
    return int(n)


def on_device(e: Expr, device: torch.device, memo: Dict[int, Expr]) -> Expr:
    """A tree of ``gather_whole`` on ``device``: each gathered vector its
    whole tensor there, each array leaf (a table, an index array) its copy
    there (``halo.replicate``)."""
    from ..parallel.halo import replicate

    hit = memo.get(id(e))
    if hit is not None:
        return hit
    if isinstance(e, _Gathered):
        out = ArrayTerminal(e.wholes[device])
    elif isinstance(e, ArrayTerminal):
        t = e.array
        out = e if t.ndim == 0 or t.device == device else ArrayTerminal(
            replicate(t, device))
    elif isinstance(e, TaggedTerminal):
        inner = on_device(e.inner, device, memo)
        out = e if inner is e.inner else TaggedTerminal(e.tag_id, inner)
    elif e.children:
        kids = [on_device(c, device, memo) for c in e.children]
        out = (e.with_children(kids) if any(
            k is not c for k, c in zip(kids, e.children)) else e)
    else:
        out = e
    memo[id(e)] = out
    return out


def whole_on(exprs: Sequence[Any], context) -> Dict[torch.device,
                                                     List[Expr]]:
    """The trees over their whole length on each distinct device of
    ``context`` (``gather_whole``, a vector they share gathered once;
    then ``on_device``)."""
    memo: Dict[int, Expr] = {}
    gathered: Dict[int, Dict] = {}
    gs = [gather_whole(as_expr(e), context, memo, gathered) for e in exprs]
    out = {}
    for dev in dict.fromkeys(context.devices):
        below: Dict[int, Expr] = {}
        out[dev] = [on_device(g, dev, below) for g in gs]
    return out


def whole_parts(node: Expr, ref):
    """A node that reads its children whole (``ReducedView``,
    ``TensordotExpr``) over the parts of ``ref``: its one-part
    ``materialize`` once a distinct device over its children made whole
    there (``whole_on``), each part a slice of its device's result (a
    new partitioned vector)."""
    from ..vector import vector

    kids = whole_on(node.children, ref.context)
    res = {dev: node.with_children(k).materialize(dev)
           for dev, k in kids.items()}
    pts = ref._pts
    return vector._from_parts(ref.context, pts, [
        res[dev][int(a):int(b)] for dev, a, b in zip(
            ref.context.devices, pts[:-1], pts[1:])])


def hoist_parts(exprs: Sequence[Expr], ref) -> Tuple[List[Expr], bool]:
    """Ready trees for a per-part evaluation over the partition of the
    vector ``ref``: (the trees with every node that reads other indices
    run first into a partitioned temporary, and what every view reads
    beneath it gathered whole onto each distinct device
    (``gather_whole``), whether any leaf differs from part to part).
    Raises NotImplementedError naming a node that reads other indices and
    is not partition-aware, ValueError on a leaf of another partition or
    length."""
    from ..ops.dispatch import not_partition_aware
    from .view import _View

    memo: Dict[int, Expr] = {}
    below: Dict[int, Expr] = {}
    gathered: Dict[int, Dict] = {}
    local = False

    def walk(e: Expr) -> Expr:
        nonlocal local
        hit = memo.get(id(e))
        if hit is not None:
            return hit
        out = e
        if isinstance(e, VectorTerminal):
            _same_partition(e.vec, ref)
        elif isinstance(e, TaggedTerminal):
            walk(e.inner)
        elif isinstance(e, ArrayTerminal):
            if e.array.ndim == 1:
                if e.array.shape[0] != ref.size:
                    raise ValueError(
                        f"array leaf of {e.array.shape[0]} elements in an "
                        f"expression over {ref.size}")
                local = True
            elif e.array.ndim:
                raise ValueError(f"array leaf of shape "
                                 f"{tuple(e.array.shape)} in an expression")
        elif isinstance(e, ElementIndex):
            local = True
        elif isinstance(e, _View):
            # the view's node differs from part to part (``part_view``)
            local = True
            own = e.own_children
            kids = [walk(c) if i in own else gather_whole(
                c, ref.context, below, gathered)
                for i, c in enumerate(e.children)]
            out = e.with_children(kids)
        elif hasattr(e, "materialize_parts"):
            out = VectorTerminal(e.materialize_parts(ref))
        elif not e._elementwise and not getattr(e, "partwise", False):
            raise not_partition_aware(type(e).__name__, ref.nparts)
        elif e.children:
            kids = [walk(c) for c in e.children]
            if any(k is not c for k, c in zip(kids, e.children)):
                out = e.with_children(kids)
        memo[id(e)] = out
        return out

    return [walk(as_expr(e)) for e in exprs], local


def part_trees(exprs: Sequence[Expr], pts: np.ndarray, d: int,
               device: Optional[torch.device] = None) -> List[Expr]:
    """The trees of part d, on ``device`` (``hoist_parts``'s, with leaves
    that differ from part to part): array leaves sliced to the part,
    ``element_index()`` the part's index plus its offset, and each view
    the part's node (``_View.part_view``) over what it reads beneath it on
    the part's device (``on_device``)."""
    from .view import _View

    a, b = int(pts[d]), int(pts[d + 1])
    memo: Dict[int, Expr] = {}
    below: Dict[int, Expr] = {}

    def arr(t: ArrayTerminal) -> ArrayTerminal:
        return ArrayTerminal(t.array[a:b]) if t.array.ndim == 1 else t

    def walk(e: Expr) -> Expr:
        hit = memo.get(id(e))
        if hit is not None:
            return hit
        if isinstance(e, ElementIndex):
            out = BinOp("add", ElementIndex(e.offset, b - a),
                        ScalarTerminal(np.int64(a)))
        elif isinstance(e, ArrayTerminal):
            out = arr(e)
        elif isinstance(e, TaggedTerminal) and isinstance(e.inner,
                                                          ArrayTerminal):
            out = TaggedTerminal(e.tag_id, arr(e.inner))
        elif isinstance(e, _View):
            own = e.own_children
            out = e.part_view([walk(c) if i in own else on_device(
                c, device, below) for i, c in enumerate(e.children)], a, b)
        elif e.children:
            kids = [walk(c) for c in e.children]
            out = (e.with_children(kids) if any(
                k is not c for k, c in zip(kids, e.children)) else e)
        else:
            out = e
        memo[id(e)] = out
        return out

    return [walk(e) for e in exprs]


def _each_part(exprs: Sequence[Expr], local: bool, ref, run) -> None:
    """``run(d, trees, m)`` with part d bound, for each part that has
    elements (part 0 alone where none has), over ``hoist_parts``'s
    ``(exprs, local)``."""
    from ..ops.dispatch import part

    pts = ref._pts
    sizes = np.diff(pts)
    devices = ref.context.devices
    for d in np.flatnonzero(sizes) if sizes.any() else [0]:
        trees = (part_trees(exprs, pts, int(d), devices[int(d)]) if local
                 else exprs)
        with part(int(d)):
            run(int(d), trees, int(sizes[d]))


def _assign_parts(targets: Sequence[Any], values: Sequence[Any],
                  ops: Sequence[str]) -> None:
    """k values into k partitioned vectors, one launch a part."""
    ref = targets[0]
    for t in targets:
        _same_partition(t, ref)
    exprs = [as_expr(v) if ASSIGN_OPS[op] is None
             else BinOp(ASSIGN_OPS[op], VectorTerminal(t), as_expr(v))
             for t, v, op in zip(targets, values, ops)]
    e = exprs[0]
    if (len(exprs) == 1 and ops[0] == "="
            and hasattr(e, "parts_into") and e.parts_into(targets[0])):
        return      # written straight into the target (``Ap[:] = A * p``)
    _run_parts(targets, *hoist_parts(exprs, ref))


def _run_parts(targets: Sequence[Any], exprs: Sequence[Expr],
               local: bool) -> None:
    """Hoisted trees into partitioned targets, one launch a part."""

    def run(d, trees, m):
        outs = [t.storage for t in targets]
        if len(outs) == 1:
            evaluate(trees[0], n=m, out=outs[0])
        else:
            evaluate_multi(trees, outs)

    _each_part(exprs, local, targets[0], run)


def evaluate_parts(expr: Any, ref, dtype=None):
    """A partitioned expression evaluated into a new vector of ``ref``'s
    partition, of ``dtype`` or the expression's type."""
    from ..types import dtype_of_code
    from ..vector import vector

    exprs, local = hoist_parts([as_expr(expr)], ref)
    dt = (dtype_of(dtype) if dtype is not None
          else dtype_of_code(infer_types(exprs[0])[id(exprs[0])]))
    out = vector._from_parts(ref.context, ref._pts, [
        torch.empty(int(b - a), dtype=dt, device=dev) for a, b, dev in zip(
            ref._pts[:-1], ref._pts[1:], ref.context.devices)])
    _run_parts([out], exprs, local)
    return out


def prepare_view_assign(view: Expr, value: Any, op: str = "=",
                        atomic: Optional[str] = None,
                        perm: Optional[bool] = None):
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
    evaluated into a temporary first.  ``perm`` says whether the target
    stands for a permutation (the owner's view of a scatter over parts
    is one whatever the view it came from); by default, whether it is
    one."""
    from .view import PermutationView

    _view_target(view)
    out = view.children[0].vec.storage
    n = view.size_hint()
    if n is None:
        raise ValueError("a view target needs a sized index")
    device = out.device
    value = as_expr(value)
    if _storages(analyze(value).leaves) & _storages([out]):
        value = ArrayTerminal(evaluate(value, n=n, device=device))
    val = CastExpr(out.dtype, value)
    if perm is None:
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


def _view_target(view: Expr):
    """The vector a view target views."""
    from .view import _View

    if not isinstance(view, _View) or not isinstance(view.children[0],
                                                     VectorTerminal):
        raise TypeError("can only assign into a view of a vector")
    return view.children[0].vec


def assign_to_view(view: Expr, value: Any, op: str = "=",
                   atomic: Optional[str] = None) -> None:
    """Write ``value`` through ``view`` into the vector it views (V3,
    ``vexcl_tpu/expr/view.py:66-100``, ``ops/atomic.py:57-124``; see
    ``prepare_view_assign``): one launch of the view-assignment kernel,
    or of the scatter route, a part of the vector that owns updates
    where it is partitioned (``_assign_to_view_parts``)."""
    if _view_target(view).nparts > 1:
        _assign_to_view_parts(view, value, op, atomic)
        return
    assign_to_view_kernel(*prepare_view_assign(view, value, op, atomic))


def _assign_to_view_parts(view: Expr, value: Any, op: str,
                          atomic: Optional[str]) -> None:
    """A write through a view into a partitioned vector, by owner
    (``parallel/collectives.owned_index``): the view's global indices (a
    permutation's index; an affine view's, as the view read over
    ``element_index``) and the value, over the view's whole length, are
    made whole on each distinct device first (``whole_on``: before any
    part is written, so a value or an index that reads the vector reads
    its old values); then each part that holds elements runs the one-part
    path over every update, its own ones at their index in the part and
    the others dropped, in their global order."""
    from ..ops.dispatch import part
    from ..parallel.collectives import owned_index
    from .view import PermutationView

    vec = _view_target(view)
    n = view.size_hint()
    if n is None:
        raise ValueError("a view target needs a sized index")
    extent = vec.size
    perm = isinstance(view, PermutationView)
    g = view.children[1] if perm else view.with_children(
        (ElementIndex(0, extent), *view.children[1:]))
    ctx, pts = vec.context, vec._pts
    whole = whole_on([g, value], ctx)
    for d in np.flatnonzero(np.diff(pts)) if n else ():
        a, b = int(pts[d]), int(pts[d + 1])
        index, val = whole[ctx.devices[d]]
        with part(int(d)):
            target = PermutationView(
                owned_index(index, extent, a, b - a, perm),
                VectorTerminal(vec), extent=b - a)
            assign_to_view_kernel(*prepare_view_assign(
                target, val, op, atomic, perm))


def eval_expr(expr: Any) -> torch.Tensor:
    """vex::eval(expr) (eval.hpp:38-110): evaluate without assigning to a
    container; returns the computed tensor (an atomic update is applied,
    and returns its vector; a partitioned expression gives a partitioned
    vector)."""
    if hasattr(expr, "execute"):
        return expr.execute()
    expr = as_expr(expr)
    from ..ops.dispatch import layout

    ref = layout(expr)
    if ref is not None:         # a partitioned vector of the value
        return evaluate_parts(expr, ref)
    return evaluate(expr)
