"""Symbolic kernel generator: record a host algorithm, replay it as one
fused device kernel.

Port of ``vexcl_tpu/generator.py`` (vexcl/generator.hpp: recorder
:75-140, symbolic :405, kernel :547, build_kernel :723-732,
make_function :740, FunctorAdapter :776-829).  The reference runs a
generic C++ algorithm (a Boost.odeint stepper) over ``vex::symbolic<T>``
values and compiles the recorded straight-line source.  Here a
``symbolic`` value carries a lazy expression tree: running the host
algorithm builds the tree, and ``build_kernel`` freezes it.  Each call
binds the parameters to the caller's vectors and evaluates every output
in ONE launch of the k-output assignment kernel
(``triton_emit.assign_multi``), which loads all before it stores, so an
in-place step reads the old state::

    x = generator.symbolic()
    for _ in range(4):                  # e.g. RK4 stages on the host
        x.assign(x - dt * x)
    step = generator.build_kernel("euler4", [x], params=[x])
    step(X)                             # X: vex.vector, updated in place

A parameter is a leaf whose tensor (or scalar) is bound only during a
call; its signature is its slot, not the bound tensor, so the kernel
cache hits from the second call on.  The recorded trees never change, so
a ``Kernel`` keeps their analysis per binding: the key is each bound
parameter's (dtype, shape, device), or a scalar's kind, and a call with
a known binding looks up the hoisted trees, the analysis, the types, the
constant leaves and the kernel's key, puts the bound tensors into their
slots and launches; the JAX package keys its jitted evaluator on the
signature the same way (``vexcl_tpu/expr/compile.py:456-498``).  Trees
with a node that runs its own kernel first (an SpMV) are hoisted anew on
every call.  ``Kernel.as_function()`` gives the
same kernel as a function of tensors returning new tensors, which
``torch.autograd`` and ``torch.func`` (``grad``, ``vmap``) compose with,
as ``jax.grad`` and ``jax.vmap`` compose with the JAX package's:

* its backward is the adjoint of the recorded trees (``expr/adjoint.py``)
  frozen into a kernel of its own, kept per (outputs given a cotangent,
  inputs needing a gradient) and binding: the gradients of vector inputs
  in one launch of the k-output kernel, those of 0-d tensor inputs (the
  sum over the elements of their adjoint) in one launch of the
  several-reduction kernel (``ops/triton_reduce.map_reduce_multi``), so
  at most two launches a backward call of elementwise trees.  It
  recomputes the forward from the inputs and stores no intermediate.
  Trees with views and partial reductions run their backward in stages
  first (``expr/adjoint.py``: a scatter a view, a V2 launch a reduction
  the rule needs, a K1 launch a materialised cotangent), with one
  ``compile.Stages`` a call, so a stage two trees read runs once.  The
  backward kernel is called through its own ``as_function``, so
  ``create_graph=True`` gives second derivatives by the same machinery.
  On the CPU the same adjoint trees run through their plain forms;
* under ``torch.func.vmap`` elementwise trees fold the batch into the
  elements: the batched arguments move their batch dimension to the
  front and flatten to B·n elements, an unbatched vector is repeated B
  times and a scalar stays: one launch, outputs of shape (B, n).  A tree
  that reads other indices than its own (a view, a pointer, a partial
  reduction, ``element_index()``) or a backward kernel with a 0-d
  gradient (a sum per batch element) runs once a batch element instead
  (B calls, each its own launches), outputs stacked.

An output's length is its tree's size where the tree has one (a view, a
reduction: ``slicer([8])[1:5](u + c)`` gives 4 elements), else the first
vector argument's; a backward kernel's gradients have their arguments'
lengths.

A call with no input that needs a gradient, outside ``torch.func``'s
transforms, launches the kernel with no autograd node.  Either way a
functional call keeps its analysis per binding (``Kernel._record``), as
a call of the kernel does.

Over the parts of a context of several parts, a call of the kernel and
its functional form (given vectors, it returns vectors of their
partition) launch the kernel once a part through the record of the
part's binding; trees that read ``element_index()`` (the global index)
or other indices than their own go through the per-part evaluator of
``expr/compile.py`` with the vector arguments as leaves.  A gradient or
a ``vmap`` over parts raises NotImplementedError naming itself.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from .expr.adjoint import adjoint
from .expr.compile import (Stages, _gathers_target, evaluate_multi,
                           prepare_multi)
from .expr.function import Function
from .expr.node import (Analysis, ArrayTerminal, CastExpr, ConstantTerminal,
                        ElementIndex, Expr, analyze, as_expr, infer_types)
from .expr.view import _View
from .expr.triton_emit import (_Launches, assign_multi,
                               assign_multi_plain, launch_key,
                               plain_values)
from .ops.triton_reduce import map_reduce_multi, map_reduce_multi_plain
from .types import code_of, dtype_of_code, scalar_code
from .vector import _ExprOpsMixin, vector

__all__ = ["symbolic", "build_kernel", "make_function", "Kernel", "backward"]

#: launches of the backward kernels (a K1 launch for the gradients of
#: vectors, a K2 launch for those of 0-d tensors), not of their plain
#: versions
backward = _Launches()


class _SymbolicParam(Expr):
    """Placeholder leaf bound to a tensor or a scalar at kernel-call time
    (the VectorParameter / ScalarParameter of generator.hpp:405)."""

    _opname = "symp"
    _uids = itertools.count(1)

    def __init__(self, kind: str):
        self.uid = next(_SymbolicParam._uids)
        self.kind = kind
        self.bound: Any = None

    def _sig(self, ctx) -> str:
        return f"p{ctx.slot(self)}"

    def leaf_key(self):
        return ("sym", self.uid)

    def payload(self):
        if self.bound is None:
            raise RuntimeError(
                "symbolic parameter used outside a kernel invocation")
        return self.bound

    def infer(self, types):
        v = self.payload()
        types[id(self)] = code = (code_of(v.dtype)
                                  if isinstance(v, torch.Tensor)
                                  else scalar_code(v))
        return code

    def emit(self, env):
        v = env.leaves[id(self)]
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(v, dtype=dtype_of_code(env.types[id(self)]),
                            device=env.device)

    def emit_src(self, em) -> str:
        leaf = em.analysis.leaves[em.analysis.slot_of[id(self)]]
        if isinstance(leaf, torch.Tensor):
            return em.load(self)
        return em.scalar(self)

    def size_hint(self):
        v = self.bound
        if isinstance(v, torch.Tensor) and v.ndim == 1:
            return int(v.shape[0])
        return None


class symbolic(_ExprOpsMixin):
    """vex::symbolic<T> (generator.hpp:405-545).

    Takes part in arithmetic like a value; ``.assign()``, ``<<=`` and
    ``s[:] = e`` record a mutation.  VectorParameter is the default;
    ``kind="scalar"`` is the ScalarParameter form (the bound value decides
    which it is)."""

    def __init__(self, kind: str = "vector", value: Any = None):
        self._param = _SymbolicParam(kind)
        self._expr: Expr = self._param if value is None else as_expr(value)

    def assign(self, value: Any) -> "symbolic":
        self._expr = as_expr(value)
        return self

    def __ilshift__(self, value: Any) -> "symbolic":  # s <<= expr
        return self.assign(value)

    def __setitem__(self, key, value) -> None:
        if isinstance(key, slice) and key == slice(None):
            self.assign(value)
        else:
            raise TypeError("symbolic supports only full assignment "
                            "s[:] = expr")

    def _as_terminal(self) -> Expr:
        return self._expr


class _Binding(NamedTuple):
    """What a call of a ``Kernel`` needs of one binding's key."""

    exprs: List[Expr]
    analysis: Analysis
    types: Dict[int, str]
    #: the leaves in slot order, a bound parameter's slot holding the
    #: first call's payload (replaced on every call)
    leaves: List[Any]
    #: (slot, argument number) of every bound parameter the trees read
    slots: List[tuple]
    #: ``triton_emit.launch_key``'s result
    keyed: tuple
    #: the outputs' types
    dtypes: List[torch.dtype]
    #: the slots of leaves brought up to date before every launch (an
    #: image's patch table, whose ``vex_refresh`` rebuilds a stale one in
    #: place)
    refresh: List[int]


def _differentiated(arrays) -> bool:
    """Whether a functional call is differentiated or batched: a
    ``torch.func`` transform is active, or an input needs a gradient."""
    return torch._C._are_functorch_transforms_active() or (
        torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in arrays))


def _binding_class(arg) -> tuple:
    """A bound argument's part of a binding's key."""
    if isinstance(arg, vector):
        arg = arg.storage
    if isinstance(arg, torch.Tensor):
        return (arg.dtype, tuple(arg.shape), arg.device)
    return (scalar_code(arg),)


def _length(e: Expr, memo: Dict[int, Optional[int]]) -> Optional[int]:
    """The number of elements a tree gives, as the JAX package's arrays
    broadcast: a view's, a reduction's or a vector's own size, the
    largest of an elementwise node's operands' (a one-element view
    broadcasts), or None where no node fixes it."""
    if id(e) not in memo:
        if e.children and e._elementwise and e._size_transparent:
            hs = [h for h in (_length(c, memo) for c in e.children)
                  if h is not None]
            memo[id(e)] = max(hs) if hs else None
        else:
            memo[id(e)] = e.size_hint()
    return memo[id(e)]


class Kernel:
    """A recorded kernel (generator.hpp kernel :547)."""

    def __init__(self, name: str, outputs: Sequence[symbolic],
                 params: Sequence[symbolic]):
        self.name = name
        self.outputs = list(outputs)
        self.params = list(params)
        # freeze the recorded trees
        self._exprs: List[Expr] = [s._expr for s in self.outputs]
        #: binding key -> _Binding, or None where the trees are hoisted
        #: anew on every call
        self._bindings: Dict[tuple, Optional[_Binding]] = {}
        #: a backward kernel's outputs that are summed over the elements
        #: (the gradients of 0-d tensors), or None for a recorded kernel
        self._summed: Optional[List[bool]] = None
        #: (outputs with a cotangent, inputs needing a gradient, binding)
        #: -> the backward kernel
        self._backward: Dict[tuple, "Kernel"] = {}
        #: a backward kernel's: the argument whose gradient each output
        #: is, and the elements a 0-d argument's gradient sums over (None
        #: for a vector's); None for a recorded kernel (``_sizes``)
        self._grad_of: Optional[List[int]] = None
        self._lengths: Optional[List[Optional[int]]] = None
        #: the outputs' lengths by binding (``_sizes``)
        self._size_of: Dict[tuple, Optional[List[int]]] = {}
        #: whether vmap folds the batch into the elements (``_folds``)
        self._fold: Optional[bool] = None

    def _bind(self, args) -> None:
        if len(args) != len(self.params):
            raise ValueError(
                f"kernel {self.name!r} expects {len(self.params)} arguments")
        for sym, arg in zip(self.params, args):
            sym._param.bound = arg.storage if isinstance(arg, vector) else arg

    def _unbind(self) -> None:
        for sym in self.params:
            sym._param.bound = None

    def _targets(self, args) -> List[vector]:
        bound = {id(sym._param): arg for sym, arg in zip(self.params, args)}
        targets = [bound.get(id(out._param)) for out in self.outputs]
        if not all(isinstance(t, vector) for t in targets):
            raise ValueError(f"the outputs of kernel {self.name!r} must be "
                             "bound to vectors")
        return targets

    def prepare(self, *args):
        """(exprs, analysis, types, leaves, outs) of a call on ``args``:
        what ``triton_emit.assign_multi`` and its plain version take."""
        outs = [t.storage for t in self._targets(args)]
        self._bind(args)
        try:
            exprs, analysis, types, leaves = prepare_multi(
                self._exprs, outs[0].shape[0], outs[0].device)
            types[id(exprs[0])]     # a parameter is typed while it is bound
            return exprs, analysis, types, leaves, outs
        finally:
            self._unbind()

    def _binding(self, args, outs) -> Optional[_Binding]:
        """The kept analysis of this binding, made at its first call."""
        key = tuple(_binding_class(a) for a in args)
        n, device = outs[0].shape[0], outs[0].device
        if key not in self._bindings and any(
                o.shape[0] != n or o.device != device for o in outs):
            raise ValueError("the targets of one fused assignment have one "
                             "length and one device")
        return self._record_of(key, args, self._exprs, n, device,
                               [o.dtype for o in outs])

    def _record_of(self, key, args, trees, n, device,
                   out_dtypes=None) -> Optional[_Binding]:
        """The record kept under ``key`` (``_record``), made at its first
        call."""
        rec = self._bindings.get(key, False)
        if rec is False:
            rec = self._record(key, args, trees, n, device, out_dtypes)
        return rec

    def _record(self, key, args, trees, n, device,
                out_dtypes=None) -> Optional[_Binding]:
        """Analyse ``trees`` bound to ``args`` over n elements of
        ``device`` and keep the record under ``key``; into outputs of
        ``out_dtypes`` (the trees' own types where None)."""
        self._bind(args)
        try:
            if analyze(*trees).hoist:
                # a node runs its own kernel first: hoisted on every call
                self._bindings[key] = None
                return None
            exprs, analysis, types, leaves = prepare_multi(trees, n, device)
            if out_dtypes is None:
                out_dtypes = [dtype_of_code(types[id(e)]) for e in exprs]
            types[id(exprs[0])]     # a parameter is typed while it is bound
        finally:
            self._unbind()
        rec = None
        payloads = [a.storage if isinstance(a, vector) else a for a in args]
        # a bound leaf must reach the kernel as it was bound (the analysis
        # neither moved nor copied it), and nothing may have been hoisted
        slots = [(analysis.slot_of[id(sym._param)], i)
                 for i, sym in enumerate(self.params)
                 if id(sym._param) in analysis.slot_of]
        if (all(e is h for e, h in zip(trees, exprs))
                and all(leaves[s] is payloads[i] for s, i in slots)):
            keyed = launch_key(exprs, analysis, out_dtypes)
            # the record keeps the bound tensors' types and shapes, not
            # their memory
            leaves = list(leaves)
            for s, i in slots:
                t = payloads[i]
                leaves[s] = None
                if isinstance(t, torch.Tensor):
                    analysis.leaves[s] = torch.empty(
                        t.shape, dtype=t.dtype, device="meta")
            refresh = [s for s, t in enumerate(leaves)
                       if hasattr(t, "vex_refresh")]
            rec = _Binding(exprs, analysis, types, leaves, slots, keyed,
                           out_dtypes, refresh)
        self._bindings[key] = rec
        return rec

    def __call__(self, *args) -> None:
        ref = next((a for a in args
                    if isinstance(a, vector) and a.nparts > 1), None)
        if ref is None:
            self._call(args)
            return
        # part by part: each vector argument is its bound part, scalars
        # are shared, through the kept record of the part's binding; trees
        # that read element_index() or other indices than their own go
        # through the per-part evaluator with the vectors as leaves
        from .expr.compile import _each_part, assign_vectors, hoist_parts

        trees = self._over(args, ref)
        exprs, local = hoist_parts(trees, ref)
        if not local and all(e is t for e, t in zip(exprs, trees)):
            _each_part(self._exprs, False, ref,
                       lambda d, trees, m: self._call(args))
            return
        self._bind_scalars(args)
        try:
            assign_vectors(self._targets(args), exprs, ["="] * len(exprs))
        finally:
            self._unbind()

    def _over(self, args, ref) -> List[Expr]:
        """The recorded trees with each vector argument's parameter
        replaced by the vector as a leaf (all of ``ref``'s partition)."""
        from .expr.compile import _same_partition
        from .expr.node import VectorTerminal

        if len(args) != len(self.params):
            raise ValueError(
                f"kernel {self.name!r} expects {len(self.params)} arguments")
        leaf = {}
        for sym, a in zip(self.params, args):
            if isinstance(a, vector):
                _same_partition(a, ref)
                leaf[id(sym._param)] = VectorTerminal(a)
        memo: Dict[int, Expr] = {}

        def sub(e: Expr) -> Expr:
            hit = memo.get(id(e))
            if hit is None:
                hit = leaf.get(id(e))
            if hit is None:
                kids = [sub(c) for c in getattr(e, "children", ())]
                hit = (e.with_children(kids) if any(
                    k is not c for k, c in zip(kids, e.children)) else e)
            memo[id(e)] = hit
            return hit

        return [sub(e) for e in self._exprs]

    def _bind_scalars(self, args) -> None:
        for sym, arg in zip(self.params, args):
            if not isinstance(arg, vector):
                sym._param.bound = arg

    def _call(self, args) -> None:
        outs = [t.storage for t in self._targets(args)]
        rec = self._binding(args, outs)
        if rec is None:
            self._bind(args)
            try:
                evaluate_multi(self._exprs, outs)
            finally:
                self._unbind()
            return
        leaves = self._leaves(rec, args)
        if rec.analysis.gathered and _gathers_target(rec.analysis, leaves,
                                                     outs):
            tmps = [torch.empty_like(o) for o in outs]
            assign_multi(rec.exprs, rec.analysis, rec.types, leaves, tmps,
                         rec.keyed)
            for o, t in zip(outs, tmps):
                o.copy_(t)
            return
        assign_multi(rec.exprs, rec.analysis, rec.types, leaves, outs,
                     rec.keyed)

    @staticmethod
    def _leaves(rec: _Binding, args) -> list:
        """The record's leaves with ``args`` put into their slots, and its
        patch tables brought up to date."""
        leaves = list(rec.leaves)
        for s, i in rec.slots:
            a = args[i]
            leaves[s] = a.storage if isinstance(a, vector) else a
        for s in rec.refresh:
            leaves[s].vex_refresh()
        return leaves

    def as_function(self) -> Callable:
        """The recorded kernel as ``fn(*tensors) -> tuple(outputs)``: new
        tensors, through the same fused kernel (one launch), on the
        arguments' device; differentiable and batchable
        (``_KernelFunction``).  Given vectors it returns vectors of the
        first vector's context and partition (``_function_of_vectors``:
        over parts, one launch a part; no gradient or vmap there)."""

        def fn(*arrays):
            if len(arrays) != len(self.params):
                raise ValueError(f"kernel {self.name!r} expects "
                                 f"{len(self.params)} arguments")
            ref = next((a for a in arrays if isinstance(a, vector)), None)
            if ref is not None:
                return self._function_of_vectors(arrays, ref)
            if _differentiated(arrays):
                return _KernelFunction.apply(self, *arrays)
            return self._evaluate(arrays)

        return fn

    def _function_of_vectors(self, arrays, ref: vector) -> tuple:
        """``as_function()`` of vectors: new vectors of ``ref``'s context
        and partition.  One part: the tensors' call on the storage.
        Several: one launch of the k-output kernel a part through the kept
        record of the part's binding, or, for trees that read
        element_index() or other indices than their own, the per-part
        evaluator over the vectors as leaves (``_over``)."""
        from .expr.compile import _each_part, hoist_parts

        if ref.nparts == 1 and all(getattr(a, "nparts", 1) == 1
                                   for a in arrays):
            outs = self.as_function()(*[
                a.storage if isinstance(a, vector) else a for a in arrays])
            return tuple(vector._adopt(o, ref.context) for o in outs)
        ref = next(a for a in arrays
                   if isinstance(a, vector) and a.nparts > 1)
        if self._summed is not None or _differentiated(arrays):
            raise NotImplementedError(
                f"a gradient or vmap of kernel {self.name!r}'s functional "
                "form (Kernel.as_function) over the parts of a context of "
                "several parts is not ported")
        trees = self._over(arrays, ref)
        exprs, local = hoist_parts(trees, ref)
        pts, devices = ref._pts, ref.context.devices
        if not local and all(e is t for e, t in zip(exprs, trees)):
            cols = [self._evaluate([a._parts[d] if isinstance(a, vector)
                                    else a for a in arrays])
                    for d in range(ref.nparts)]
            return tuple(vector._from_parts(ref.context, pts, list(c))
                         for c in zip(*cols))
        self._bind_scalars(arrays)
        try:
            types = infer_types(*exprs)
            outs = [vector._from_parts(ref.context, pts, [
                torch.empty(int(b - a), dtype=dtype_of_code(types[id(e)]),
                            device=dev)
                for a, b, dev in zip(pts[:-1], pts[1:], devices)])
                for e in exprs]

            def run(d, part_trees, m):
                evaluate_multi(part_trees, [o.storage for o in outs])

            _each_part(exprs, local, ref, run)
        finally:
            self._unbind()
        return tuple(outs)

    def _evaluate(self, arrays, plain: bool = False) -> tuple:
        """The outputs over their lengths (``_sizes``): the elementwise
        ones of one length in one launch of the k-output kernel, a
        backward kernel's summed ones in one launch of the
        several-reduction kernel; with ``plain``, both kernels' plain
        versions."""
        n, device = self._extent(arrays)
        # a kept record passes a tensor to the kernel as it is: a strided
        # one (the stride-0 cotangent of a sum) is made contiguous first,
        # as the analysis would
        arrays = [a.contiguous() if isinstance(a, torch.Tensor) else a
                  for a in arrays]
        key = tuple(map(_binding_class, arrays))
        sizes = self._sizes(n, key, arrays)
        if sizes is None:
            # outputs of one length, none summed: one launch
            return tuple(self._part(arrays, key, self._exprs, False, n,
                                    device, plain))
        summed = self._summed or [False] * len(self._exprs)
        groups: Dict[tuple, List[int]] = {}
        for i, red_m in enumerate(zip(summed, sizes)):
            groups.setdefault(red_m, []).append(i)
        outs: List[Any] = [None] * len(self._exprs)
        for (red, m), idx in sorted(groups.items()):
            got = self._part(arrays, key, [self._exprs[i] for i in idx], red,
                             m, device, plain)
            for i, v in zip(idx, got):
                outs[i] = v
        return tuple(outs)

    def _sizes(self, n: int, key: tuple, arrays) -> Optional[List[int]]:
        """Each output's length over ``arrays`` (binding ``key``): a
        backward kernel's gradient has its argument's length, or sums
        over ``_lengths``' elements (a 0-d argument's); a recorded
        kernel's output its tree's (``_length``, the parameters bound),
        else n (the first vector argument's length).  None where every
        output has n elements and none is summed."""
        got = self._size_of.get(key, False)
        if got is False:
            if self._grad_of is not None:
                got = [arrays[i].shape[0] if arrays[i].ndim else m
                       for i, m in zip(self._grad_of, self._lengths)]
            else:
                memo: Dict[int, Optional[int]] = {}
                self._bind(arrays)
                try:
                    hints = [_length(e, memo) for e in self._exprs]
                finally:
                    self._unbind()
                got = [n if h is None else int(h) for h in hints]
            if all(m == n for m in got) and not any(self._summed or ()):
                got = None
            self._size_of[key] = got
        return got

    def _part(self, arrays, key: tuple, trees, red: bool, n: int, device,
              plain: bool) -> list:
        """The values of ``trees`` over n elements: new tensors of their
        types, or (``red``) their sums, 0-d tensors of their types.  A
        kernel's call looks up the record of its binding ``key``
        (``_record``, made at the first call), as ``__call__`` does; the
        plain versions and a tree hoisted anew on every call analyse the
        trees again, the stages of one call in one ``compile.Stages``
        (``plain``: by their plain versions)."""
        rec = None if plain else self._record_of(("fn", red, n, *key), arrays,
                                                 trees, n, device)
        if rec is None:
            self._bind(arrays)
            try:
                return self._hoisted(trees, red, n, device, plain)
            finally:
                self._unbind()
        return self._run(rec.exprs, rec.analysis, rec.types,
                         self._leaves(rec, arrays), rec.dtypes, rec.keyed,
                         red, n, device, False)

    def _hoisted(self, trees, red: bool, n: int, device,
                 plain: bool) -> list:
        """``_part`` of trees analysed anew: an output that a stage wrote
        whole (a tree that is one view's scatter or one reduction) is that
        stage's tensor, which saves a K1 copy of it; the rest go through
        the kernel."""
        stages = Stages(plain)
        exprs, analysis, types, leaves = prepare_multi(trees, n, device,
                                                       stages)
        dts = [dtype_of_code(types[id(e)]) for e in exprs]
        made: Dict[int, torch.Tensor] = {}
        if not red:
            seen = set()
            for i, (e, t, dt) in enumerate(zip(exprs, trees, dts)):
                if e is not t and isinstance(e, ArrayTerminal) \
                        and e.array.dtype == dt \
                        and tuple(e.array.shape) == (n,):
                    a = e.array
                    made[i] = a.clone() if id(a) in seen else a
                    seen.add(id(a))
        if not made:
            return self._run(exprs, analysis, types, leaves, dts, None, red,
                             n, device, plain)
        rest = [i for i in range(len(exprs)) if i not in made]
        if rest:
            exprs, analysis, types, leaves = prepare_multi(
                [exprs[i] for i in rest], n, device, stages)
            for i, v in zip(rest, self._run(
                    exprs, analysis, types, leaves, [dts[i] for i in rest],
                    None, red, n, device, plain)):
                made[i] = v
        return [made[i] for i in range(len(trees))]

    def _run(self, exprs, analysis, types, leaves, dts, keyed, red: bool,
             n: int, device, plain: bool) -> list:
        """The values of the prepared ``exprs`` (``_part``): with ``plain``
        or on the CPU by the kernels' plain versions, else by one launch
        of the kernel, after which a backward kernel adds one to
        ``backward``'s count."""
        if n == 0:      # nothing to launch: no values, zero sums
            return [torch.zeros((), dtype=dt, device=device) if red
                    else torch.empty(0, dtype=dt, device=device)
                    for dt in dts]
        launch = not plain and device.type != "cpu"
        if red:
            pairs = [(e, "SUM") for e in exprs]
            if launch:
                sums = map_reduce_multi(pairs, analysis, types, leaves, n,
                                        device)
                self._launched()
            else:
                sums = map_reduce_multi_plain(pairs, analysis, types, leaves,
                                              n, device)
            return [s.to(dt) for s, dt in zip(sums, dts)]
        if plain:
            return plain_values(exprs, analysis, types, leaves, n, device)
        outs = [torch.empty(n, dtype=dt, device=device) for dt in dts]
        if launch:
            assign_multi(exprs, analysis, types, leaves, outs, keyed)
            self._launched()
        else:
            assign_multi_plain(exprs, analysis, types, leaves, outs)
        return outs

    def _launched(self) -> None:
        """Count a launch of this kernel where it is a backward kernel."""
        if self._summed is not None:
            backward.launches += 1

    def _extent(self, arrays):
        """(n, device) of a functional call: its first vector's."""
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.ndim:
                return a.shape[0], a.device
        raise ValueError(f"kernel {self.name!r} needs a vector (a 1-D "
                         "tensor) argument")

    def prepare_function(self, *arrays):
        """(exprs, analysis, types, leaves) of ``as_function()``'s
        elementwise outputs on ``arrays``: what ``triton_emit.assign_multi``
        and its plain version take, into tensors of the trees' types."""
        n, device = self._extent(arrays)
        summed = self._summed or [False] * len(self._exprs)
        sizes = self._sizes(n, tuple(map(_binding_class, arrays)), arrays)
        n = next((m for m, s in zip(sizes or (), summed) if not s), n)
        self._bind(arrays)
        try:
            prepared = prepare_multi([e for e, s in zip(self._exprs, summed)
                                      if not s], n, device)
            prepared[2][id(prepared[0][0])]     # typed while it is bound
            return prepared
        finally:
            self._unbind()

    def plain(self, *arrays) -> tuple:
        """``as_function()``'s outputs by the plain PyTorch versions of its
        kernels (the trees' ``emit`` forms), with no autograd node of the
        kernel's: what the card compares the kernels with."""
        return self._evaluate(arrays, plain=True)

    def backward_kernel(self, arrays, cots, needs) -> "Kernel":
        """The backward kernel of a call on ``arrays`` whose outputs have
        the cotangents ``cots`` (None: none), for the arguments that
        ``needs`` a gradient: its arguments are ``arrays`` and the given
        cotangents, its outputs the gradients in argument order.  Made at
        the first call of a (mask, binding) and kept."""
        key = (tuple(c is not None for c in cots), tuple(needs),
               tuple(_binding_class(a) for a in (*arrays, *cots)
                     if a is not None))
        bk = self._backward.get(key)
        if bk is None:
            bk = self._backward[key] = self._adjoint_kernel(arrays, cots,
                                                            needs)
        return bk

    def _gradients(self, arrays, cots, needs) -> List[Optional[torch.Tensor]]:
        """The gradient of each argument that ``needs`` one (None for the
        rest): one call of the backward kernel."""
        grads = iter(self.backward_kernel(arrays, cots, needs).as_function()(
            *arrays, *[c for c in cots if c is not None]))
        return [next(grads) if need else None for need in needs]

    def _adjoint_kernel(self, arrays, cots, needs) -> "Kernel":
        """The backward kernel: over this kernel's parameters and one
        cotangent parameter per output given one, an output per argument
        that needs a gradient (the adjoint of its parameter, in its type;
        summed where the argument is 0-d)."""
        csyms = [symbolic() if c is not None else None for c in cots]
        given = [(s, c) for s, c in zip(csyms, cots) if s is not None]
        wanted = [i for i, need in enumerate(needs) if need]
        n = self._extent(arrays)[0]
        sizes = (self._sizes(n, tuple(map(_binding_class, arrays)), arrays)
                 or [n] * len(self._exprs))
        self._bind(arrays)
        for s, c in given:
            s._param.bound = c
        try:
            # typed as the walk reaches them: a node with no type rule
            # raises there, naming itself
            types: Dict[int, str] = {}
            trees, lengths = adjoint(
                self._exprs,
                [s._param if s is not None else None for s in csyms],
                [self.params[i]._param for i in wanted], types, sizes)
        finally:
            self._unbind()
            for s, _ in given:
                s._param.bound = None
        outs = []
        for i, tree in zip(wanted, trees):
            dt = arrays[i].dtype
            # no path from an output: a zero gradient, from the kernel
            outs.append(symbolic(value=CastExpr(dt, ConstantTerminal(0.0))
                                 if tree is None else tree))
        bk = Kernel(f"{self.name}_backward", outs,
                    [*self.params, *(s for s, _ in given)])
        bk._summed = [arrays[i].ndim == 0 for i in wanted]
        # a vector's gradient has its length; a 0-d one sums its adjoint
        # over the elements it was read over
        bk._grad_of = wanted
        bk._lengths = [None if arrays[i].ndim else (n if m is None else m)
                       for i, m in zip(wanted, lengths)]
        return bk

    def _folds(self) -> bool:
        """Whether vmap may fold the batch into the elements: every node
        of the trees reads at its own index (no view, no node that runs
        its own kernel, no ``element_index()``) and no output is summed."""
        if self._fold is None:
            fold = not any(self._summed or ())
            seen, stack = set(), list(self._exprs)
            while fold and stack:
                e = stack.pop()
                if id(e) in seen:
                    continue
                seen.add(id(e))
                if isinstance(e, (_View, ElementIndex)) \
                        or not e._elementwise:
                    fold = False
                stack.extend(e.children)
            self._fold = fold
        return self._fold


class _KernelFunction(torch.autograd.Function):
    """``Kernel.as_function()`` under autograd and ``torch.func``: the
    forward is the kernel's one launch; the backward is its backward
    kernel's ``as_function`` (so it is differentiable in turn); ``vmap``
    flattens the batch into the elements where the trees allow it
    (``Kernel._folds``), else calls the kernel once a batch element."""

    @staticmethod
    def forward(kernel, *arrays):
        return kernel._evaluate(arrays)

    @staticmethod
    def setup_context(ctx, inputs, output):
        kernel, *arrays = inputs
        ctx.kernel = kernel
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*[a for a in arrays
                                if isinstance(a, torch.Tensor)])
        #: the non-tensor arguments, None at a tensor's place
        ctx.scalars = [None if isinstance(a, torch.Tensor) else a
                       for a in arrays]

    @staticmethod
    def backward(ctx, *cots):
        saved = iter(ctx.saved_tensors)
        arrays = [next(saved) if a is None else a for a in ctx.scalars]
        return (None, *ctx.kernel._gradients(arrays, cots,
                                             ctx.needs_input_grad[1:]))

    @staticmethod
    def vmap(info, in_dims, kernel, *arrays):
        b, dims = info.batch_size, in_dims[1:]
        if not kernel._folds():
            # one call a batch element: a view's index map addresses the
            # elements of one batch element
            cols = [_KernelFunction.apply(kernel, *[
                a.select(d, i) if d is not None else a
                for a, d in zip(arrays, dims)]) for i in range(b)]
            outs = tuple(torch.stack(c) for c in zip(*cols))
            return outs, (0,) * len(outs)
        shapes = [a.shape if d is None else a.shape[:d] + a.shape[d + 1:]
                  for a, d in zip(arrays, dims) if isinstance(a, torch.Tensor)]
        ns = {s[0] for s in shapes if len(s) == 1}
        if len(ns) != 1:
            raise ValueError(f"vmap of {kernel.name!r}: the vector arguments "
                             "need one length")
        n = ns.pop()
        flat = []
        for a, d in zip(arrays, dims):
            if isinstance(a, torch.Tensor) and d is not None:
                a = a.movedim(d, 0)
                if a.ndim == 1:         # one scalar a batch element
                    a = a[:, None].expand(b, n)
                a = a.reshape(b * n)
            elif isinstance(a, torch.Tensor) and a.ndim:
                a = a.expand(b, n).reshape(b * n)
            flat.append(a)
        outs = _KernelFunction.apply(kernel, *flat)
        return tuple(o.reshape(b, n) for o in outs), (0,) * len(outs)


def build_kernel(name: str, outputs: Sequence[symbolic],
                 params: Sequence[symbolic]) -> Kernel:
    """generator::build_kernel (generator.hpp:723-732): freeze the recorded
    state of ``outputs`` into a reusable fused kernel over ``params``."""
    return Kernel(name, outputs, params)


def make_function(functor: Callable, name: Optional[str] = None) -> Function:
    """generator::make_function<Signature> (generator.hpp:740-829): a
    generic host functor as a device function whose body is inlined into
    the calling expression's kernel."""
    return Function(name or getattr(functor, "__name__", "generated"),
                    functor)
