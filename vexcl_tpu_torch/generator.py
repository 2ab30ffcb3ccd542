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
same kernel as a function of tensors returning new tensors; it has no
backward kernel yet and refuses inputs that require a gradient.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from .expr.compile import _gathers_target, evaluate_multi, prepare_multi
from .expr.function import Function
from .expr.node import Analysis, Expr, as_expr
from .expr.triton_emit import assign_multi, launch_key
from .types import code_of, dtype_of_code, scalar_code
from .vector import _ExprOpsMixin, vector

__all__ = ["symbolic", "build_kernel", "make_function", "Kernel"]


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


def _binding_class(arg) -> tuple:
    """A bound argument's part of a binding's key."""
    if isinstance(arg, vector):
        arg = arg.storage
    if isinstance(arg, torch.Tensor):
        return (arg.dtype, tuple(arg.shape), arg.device)
    return (scalar_code(arg),)


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
        try:
            return self._bindings[key]
        except KeyError:
            pass
        n, device = outs[0].shape[0], outs[0].device
        if any(o.shape[0] != n or o.device != device for o in outs):
            raise ValueError("the targets of one fused assignment have one "
                             "length and one device")
        exprs, analysis, types, leaves, _ = self.prepare(*args)
        rec = None
        payloads = [a.storage if isinstance(a, vector) else a for a in args]
        # a bound leaf must reach the kernel as it was bound (the analysis
        # neither moved nor copied it), and nothing may have been hoisted
        slots = [(analysis.slot_of[id(sym._param)], i)
                 for i, sym in enumerate(self.params)
                 if id(sym._param) in analysis.slot_of]
        if (all(e is h for e, h in zip(self._exprs, exprs))
                and all(leaves[s] is payloads[i] for s, i in slots)):
            keyed = launch_key(exprs, analysis, [o.dtype for o in outs])
            # the record keeps the bound tensors' types and shapes, not
            # their memory
            leaves = list(leaves)
            for s, i in slots:
                t = payloads[i]
                leaves[s] = None
                if isinstance(t, torch.Tensor):
                    analysis.leaves[s] = torch.empty(
                        t.shape, dtype=t.dtype, device="meta")
            rec = _Binding(exprs, analysis, types, leaves, slots, keyed)
        self._bindings[key] = rec
        return rec

    def __call__(self, *args) -> None:
        outs = [t.storage for t in self._targets(args)]
        rec = self._binding(args, outs)
        if rec is None:
            self._bind(args)
            try:
                evaluate_multi(self._exprs, outs)
            finally:
                self._unbind()
            return
        leaves = list(rec.leaves)
        for s, i in rec.slots:
            a = args[i]
            leaves[s] = a.storage if isinstance(a, vector) else a
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

    def as_function(self) -> Callable:
        """The recorded kernel as ``fn(*tensors) -> tuple(outputs)``: new
        tensors, through the same fused kernel (one launch), on the
        arguments' device."""

        def fn(*arrays):
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in arrays):
                raise NotImplementedError(
                    f"kernel {self.name!r} has no backward kernel: call it "
                    "under torch.no_grad() or on tensors that need no "
                    "gradient")
            tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
            if not tensors:
                raise ValueError(f"kernel {self.name!r} needs a tensor "
                                 "argument")
            self._bind(arrays)
            try:
                return evaluate_multi(self._exprs, n=tensors[0].shape[0],
                                      device=tensors[0].device)
            finally:
                self._unbind()

        return fn


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
