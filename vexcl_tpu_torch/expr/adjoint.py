"""Reverse-mode symbolic differentiation of a recorded expression DAG.

The JAX package's ``Kernel.as_function()`` (``vexcl_tpu/generator.py:
175-206``) is a JAX function, so ``jax.grad`` differentiates it: XLA's
autodiff of the traced ``jnp`` code, no Pallas kernel.  The port has no
tracer, so it differentiates the recorded trees themselves.  ``adjoint``
takes the k output trees of a kernel, one cotangent leaf per output and
the parameters that need a gradient, and gives one adjoint tree per
parameter: an elementwise expression over the kernel's inputs and the
cotangents, which the generator freezes into a kernel of its own and
evaluates in one launch of the generated k-output kernel (K1;
``generator.Kernel.as_function``).  The backward kernel recomputes the
forward from the inputs: it stores no intermediate, it reads the inputs
and the cotangents and writes the gradients.

The DAG is walked once in reverse topological order.  The adjoint trees
refer to the forward nodes themselves (a product's contribution is
``g * b`` with b the forward node), so the emitter's memo, which is by
node, computes each forward node once in the backward kernel: the RK4
step's stages are shared by every gradient as they are by every output.
Each adjoint is accumulated in its node's type (a contribution of
another float type is cast to it, as JAX transposes a
``convert_element_type``); nothing flows into an integer or boolean node.

The rules by node class (``expr/node.py``), as JAX differentiates what
the JAX package computes:

* ``BinOp`` and ``UnOp``: ``+ - * / **``, ``%`` (jnp.remainder),
  ``fmod``, ``atan2``, ``hypot``, ``copysign``, ``fdim``, min and max (a
  tie splits), unary ``-`` and ``abs`` (1 at 0); ``//`` and the orders
  have a zero gradient, the bitwise and logical operators an integer or
  boolean result;
* ``FuncCall``: the rule of its catalog entry (``builtins.GRADIENTS``);
  a user ``Function``'s body is already an inlined tree;
* ``Where``: the selected branch only, never the condition;
* ``CastExpr``: float to float casts the adjoint back; a cast to an
  integer or boolean type stops it;
* ``Temporary``: passes it through; the leaves (``TaggedTerminal`` too)
  and the parameters not asked for: stop;
* a view with an index map (``PermutationView``, ``PointerDeref``,
  ``SliceTerminal``, ``MultiSliceView``, ``ReshapeView``): the adjoint of
  a gather is a scatter, ``ViewAdjoint``: zeros of the operand's length
  with the view's cotangent added at the indices the view reads, the
  index derived from the view's own ``plain_index``/``emit_index``, so
  wrapped, clamped and dropped keys follow the forward and duplicates
  accumulate;
* ``ReducedView``, as JAX differentiates ``jnp.sum``/``min``/``max``/
  ``prod``: the cotangent broadcast back along the reduced axes (an index
  map over the materialised cotangent, ``Stage``); min and max by the
  chooser rule ``g * (x == r) / count(x == r)``, so ties split equally;
  prod as the product of the others (one zero in a row gets the product
  of the rest, two or more give 0);
* every other node whose adjoint needs another kernel (the SpMV, the
  stencils, FFT, MBA, images, random numbers) raises
  ``NotImplementedError`` naming the node, and only when a gradient is
  asked through it.  Complex values raise too, and so does a second
  derivative through a view's scatter.

The views and reductions make the backward run in stages: each
``ViewAdjoint``, ``Stage`` and reduction is a node that runs its own
kernel first (``compile.hoist``), one after another from the innermost
out: the scatter (V3's kernel, or a form of ``csrc/scatter.cu`` where
``cuda_scatter.route`` sends a permutation's atomic add), a K1 launch
of a materialised cotangent, a V2 launch of a reduction, then the
gradients' own K1 launch, which reads what the stages wrote.  Each node
has one length (the elements it is evaluated over); a value read over
two lengths (a 0-d argument beneath a view and beside it) raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..types import dtype_of_code
from .builtins import BUILTINS, GRADIENTS, _expands, _k
from .node import (BinOp, CastExpr, ElementIndex, EmitEnv, Expr, FuncCall,
                   Temporary, UnOp, Where, _Op)
from .view import PermutationView, ReducedView, ReshapeView, _AffineView

__all__ = ["adjoint", "Stage", "ViewAdjoint"]


class Stage(Expr):
    """An elementwise tree's values over its m elements, written into a
    temporary by one launch of the k-output kernel (K1; its plain version
    where the ``compile.Stages`` ask for it) before the stage that reads
    them at other indices."""

    _elementwise = False
    _size_transparent = False
    takes_stages = True
    _opname = "stage"

    def __init__(self, tree: Expr, m: int):
        self.m = int(m)
        self.children = (tree,)

    def extra_sig(self) -> str:
        return str(self.m)

    def _infer(self, child_codes):
        return child_codes[0]

    def child_sizes(self, m):
        return [self.m]

    def size_hint(self) -> Optional[int]:
        return self.m

    def materialize(self, device: torch.device, n: Optional[int] = None,
                    stages=None):
        from .compile import evaluate_multi, prepare_multi
        from .triton_emit import plain_value

        if stages is not None and stages.plain:
            (e,), analysis, types, leaves = prepare_multi(
                self.children, self.m, device, stages)
            return plain_value(e, analysis, types, leaves, self.m,
                               device).contiguous()
        return evaluate_multi(self.children, n=self.m, device=device,
                              stages=stages)[0]

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)


def _staged(g: Expr, m: int) -> Expr:
    """``g`` as a tensor that a view can read at other indices: a leaf as
    it is, any other tree materialised by a ``Stage``."""
    return g if not g.children else Stage(g, m)


class ViewAdjoint(Expr):
    """The adjoint of a view's operand: zeros of the operand's length
    (the view's extent) with the view's cotangent (``children[0]``, over
    the m elements the view is evaluated over) added at the indices the
    view reads them from, through the view-assignment path
    (``triton_emit.assign_to_view``: V3's kernel, or a form of
    ``csrc/scatter.cu`` where ``cuda_scatter.route`` takes a
    permutation's add; ``assign_to_view_plain`` where the
    ``compile.Stages`` ask for it).  The index is the view's own over an
    ``element_index`` operand, so wrapped, clamped and dropped keys follow
    the forward, and duplicates accumulate.  A view that cannot collide
    (slices whose axes of more than one element all move the index)
    stores its values; the rest add them atomically."""

    _elementwise = False
    _size_transparent = False
    takes_stages = True
    _opname = "view_adjoint"

    def __init__(self, view, g: Expr, m: int, code: str):
        self.view = view
        self.m = int(m)
        self.code = code
        self.children = (g,)

    def extra_sig(self) -> str:
        return f"{type(self.view).__name__}|{self.m}"

    def _infer(self, child_codes):
        return self.code

    def child_sizes(self, m):
        return [self.m]

    def size_hint(self) -> Optional[int]:
        return self.view.extent

    def mode(self) -> str:
        """``store`` where no two elements of the view read one index,
        else ``add``."""
        v = self.view
        if isinstance(v, _AffineView) and not v.broadcast and all(
                g is None and (coef != 0 or c == 1)
                for c, coef, g, _ in v.axes):
            return "store"
        return "add"

    def materialize(self, device: torch.device, n: Optional[int] = None,
                    stages=None):
        from .compile import fit_index_bits, prepare_multi
        from .triton_emit import assign_to_view, assign_to_view_plain

        view, dt = self.view, dtype_of_code(self.code)
        out = torch.zeros(view.extent, dtype=dt, device=device)
        reader = view.with_children((ElementIndex(0, view.extent),
                                     *view.children[1:]))
        (value, target), analysis, types, leaves = prepare_multi(
            [CastExpr(dt, self.children[0]), reader], self.m, device, stages)
        fit_index_bits(analysis, max(self.m, view.extent))
        plain = stages is not None and stages.plain
        run = assign_to_view_plain if plain else assign_to_view
        run(value, target, analysis, types, leaves, out, self.mode(),
            self.m)
        return out

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)


@_expands
def _rem_tree(a, b):
    """jnp.remainder of floats: lax.rem, plus b where the signs differ."""
    r = BUILTINS["fmod"](a, b)
    zero = _k(0.0)
    return Where((r != zero) & ((r < zero) != (b < zero)), r + b, r)


#: the operators' rules, in the form of ``builtins.GRADIENTS``
_OPERATORS = {
    "add": lambda g, o, a, b: (g, g),
    "sub": lambda g, o, a, b: (g, -g),
    "mul": lambda g, o, a, b: (g * b, a * g),
    # lax.div: g / y, and -(g y^-2) x
    "div": lambda g, o, a, b: (g / b, -((g * (_k(1.0) / (b * b))) * a)),
    "pow": GRADIENTS["pow"],
    "floordiv": lambda g, o, a, b: (None, None),
    "mod": _rem_tree,
    "fmod": GRADIENTS["fmod"],
    "atan2": GRADIENTS["atan2"],
    "min": GRADIENTS["fmin"],
    "max": GRADIENTS["fmax"],
    "hypot": GRADIENTS["hypot"],
    "copysign": GRADIENTS["copysign"],
    "fdim": GRADIENTS["fdim"],
    "neg": lambda g, o, a: (-g,),
    "abs": GRADIENTS["fabs"],
}


def _describe(node: Expr) -> str:
    op = getattr(node, "op", None)
    return type(node).__name__ + (f" {op!r}" if op else "")


class _Adjoint:
    """One reverse walk.  ``types`` holds the forward nodes' codes and
    takes those of the nodes the walk builds; ``keep`` holds every node
    built, so that no id in ``types`` is reused by another node while the
    walk runs."""

    def __init__(self, types: Dict[int, str]):
        self.types = types
        self.keep: List[Expr] = []
        #: (id(node), code) -> the node cast to that code, one a pair
        self._casts: Dict[tuple, Expr] = {}

    def code(self, node: Expr) -> str:
        self.keep.append(node)
        try:
            return node.infer(self.types)
        except NotImplementedError:
            # a node with no type rule runs its own kernel (an SpMV, a
            # stencil): name the innermost one
            bad = node
            while True:
                kid = next((c for c in bad.children
                            if not self._typed(c)), None)
                if kid is None:
                    break
                bad = kid
            raise NotImplementedError(
                f"no gradient through {_describe(bad)}: its adjoint needs "
                "a kernel of its own, which the backward does not have"
            ) from None

    def _typed(self, node: Expr) -> bool:
        try:
            node.infer(self.types)
            return True
        except NotImplementedError:
            return False

    def cast(self, node: Expr, code: str) -> Expr:
        """``node`` in type ``code`` (itself where it has that type; one
        cast node a (node, type), so that the kernel casts it once)."""
        if dtype_of_code(self.code(node)) == dtype_of_code(code):
            return node
        key = (id(node), dtype_of_code(code))
        if key not in self._casts:
            self._casts[key] = CastExpr(dtype_of_code(code), node)
        return self._casts[key]

    def is_float(self, node: Expr) -> bool:
        dt = dtype_of_code(self.code(node))
        if dt.is_complex:
            raise NotImplementedError(
                f"no gradient through the complex value of "
                f"{_describe(node)}: the adjoint covers real types")
        return dt.is_floating_point

    def walk(self, roots: Sequence[Expr], cots: Sequence[Optional[Expr]],
             wrt: Sequence[Expr],
             sizes: Optional[Sequence[Optional[int]]] = None
             ) -> List[Optional[Expr]]:
        """The adjoint of each of ``wrt`` (None where no path reaches it)
        given the cotangent of each root, over ``sizes`` elements each
        (None: unknown, as inside a builtin's expansion); ``lengths``
        then holds the length of each adjoint of ``wrt``."""
        stop = {id(w) for w in wrt}
        order, depends = self._order(roots, stop)
        #: id -> (adjoint, the elements it is over)
        bar: Dict[int, tuple] = {}

        def add(node: Expr, g: Optional[Expr], m: Optional[int]) -> None:
            if g is None or id(node) not in depends \
                    or not self.is_float(node):
                return
            g = self.cast(g, self.code(node))
            self.keep.append(g)
            prev = bar.get(id(node))
            if prev is None:
                bar[id(node)] = (g, m)
                return
            if None not in (m, prev[1]) and m != prev[1]:
                raise NotImplementedError(
                    f"no gradient through {_describe(node)}: it is read "
                    f"over {prev[1]} and over {m} elements (a value beneath "
                    "a view and beside it)")
            bar[id(node)] = (BinOp("add", prev[0], g),
                             m if prev[1] is None else prev[1])

        for r, c, m in zip(roots, cots, sizes or [None] * len(roots)):
            add(r, c, m)
        for node in reversed(order):
            got = bar.get(id(node))
            if got is None or id(node) in stop:
                continue
            g, m = got
            for child, cm, contrib in zip(node.children,
                                          node.child_sizes(m),
                                          self.contributions(node, g, m)):
                add(child, contrib, cm)
        self.lengths = [bar.get(id(w), (None, None))[1] for w in wrt]
        return [bar.get(id(w), (None,))[0] for w in wrt]

    @staticmethod
    def _order(roots: Sequence[Expr], stop: set):
        """(the nodes in post order, the ids of those from which a node
        of ``stop`` is reached), the walk ending at ``stop``."""
        order: List[Expr] = []
        depends = set()
        seen = set()
        stack = [(r, False) for r in reversed(roots)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                if id(node) in stop or any(id(c) in depends
                                           for c in node.children):
                    depends.add(id(node))
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            if id(node) not in stop:
                stack.extend((c, False) for c in reversed(node.children))
        return order, depends

    def contributions(self, node: Expr, g: Expr, m: Optional[int] = None):
        """One contribution of ``g`` (over m elements) per child of
        ``node``."""
        if isinstance(node, Where):
            zero = _k(0.0)
            c = node.children[0]
            return None, Where(c, g, zero), Where(c, zero, g)
        if isinstance(node, (CastExpr, Temporary, Stage)):
            return (g,)
        if isinstance(node, (BinOp, UnOp, FuncCall)):
            return self._op(node, g)
        if isinstance(node, (PermutationView, _AffineView)) \
                and node._part is None and m is not None:
            # the scatter of the gather: the cotangent, in the operand's
            # type, added at the indices the view reads
            return (ViewAdjoint(node, g, m,
                                self.code(node.children[0])),
                    *[None] * (len(node.children) - 1))
        if isinstance(node, ReducedView) and m == node.size_hint():
            return (self._reduced(node, g, m),)
        if isinstance(node, ViewAdjoint):
            raise NotImplementedError(
                f"no second derivative through {_describe(node.view)}: the "
                "adjoint of its scatter (a gather) is not ported")
        raise NotImplementedError(
            f"no gradient through {_describe(node)}: its adjoint needs a "
            "kernel of its own, which the backward does not have")

    def _reduced(self, node: ReducedView, g: Expr, m: int) -> Expr:
        """The adjoint of a ``ReducedView``'s operand given its cotangent
        ``g`` over its m kept elements: JAX's rules for ``jnp.sum``,
        ``min``, ``max`` and ``prod``."""
        shape, axes = node.shape, node.axes
        kept = tuple(a for a in range(len(shape)) if a not in axes)
        x = node.children[0]
        dt = dtype_of_code(self.code(x))

        def spread(t: Expr) -> Expr:
            """A tensor of the kept elements read at every element of the
            operand: the broadcast along the reduced axes."""
            return ReshapeView(t, shape, kept)

        def total(op: str, e: Expr) -> Expr:
            """``e`` over the operand's elements reduced as ``node`` is
            (V2)."""
            return ReducedView(op, ReshapeView(e, shape, range(len(shape))),
                               axes)

        if node.op == "sum":
            return spread(_staged(g, m))
        if node.op in ("min", "max"):
            # the chooser rule: ties split the cotangent equally
            hit = CastExpr(dt, BinOp("eq", x, spread(node)))
            share = Stage(g / total("sum", hit), m)
            return spread(share) * hit
        # prod: g times the product of the others, without a division by
        # a zero: one zero in a row takes the product of the rest, two or
        # more give 0
        zero = BinOp("eq", x, _k(0.0))
        zeros = spread(total("sum", CastExpr(dt, zero)))
        rest = Stage(g * total("prod", Where(zero, _k(1.0), x)), m)
        q = spread(rest)
        return Where(zeros == _k(0.0), q / x,
                     Where((zeros == _k(1.0)) & zero, q, _k(0.0)))

    def _op(self, node: _Op, g: Expr):
        table = GRADIENTS if isinstance(node, FuncCall) else _OPERATORS
        rule = table.get(node.op, "it has no derivative rule")
        if isinstance(rule, str):
            raise NotImplementedError(
                f"no gradient through {_describe(node)}: {rule}")
        self.code(node)             # types the nodes an expansion built
        acs, _, _ = node._codes(self.types)
        args = [self.cast(c, a) for c, a in zip(node.children, acs)]
        if getattr(rule, "expands", False):
            tree = rule(*args)
            self.keep.append(tree)
            got = self.walk([tree], [g], args)
            # an operand given twice (mad(x, x, y)) takes its total once
            firsts = {}
            for i, a in enumerate(args):
                firsts.setdefault(id(a), i)
            return [c if firsts[id(a)] == i else None
                    for i, (a, c) in enumerate(zip(args, got))]
        if getattr(rule, "typed", False):
            return rule([self.types[id(c)] for c in node.children], g, node,
                        *args)
        return rule(g, node, *args)


def adjoint(roots: Sequence[Expr], cotangents: Sequence[Optional[Expr]],
            wrt: Sequence[Expr], types: Dict[int, str],
            sizes: Optional[Sequence[int]] = None) -> tuple:
    """(the adjoint tree of each of ``wrt``, its length): ``wrt`` are
    parameter leaves of the trees ``roots``, given one cotangent leaf per
    root (None: no cotangent) over the root's ``sizes`` elements; each
    tree in its parameter's type, None where no path from a root with a
    cotangent reaches it.  ``types`` holds the codes of the trees' nodes
    (``node.infer_types``, the parameters and the cotangents bound) and
    receives those of the nodes built."""
    walk = _Adjoint(types)
    trees = walk.walk(list(roots), list(cotangents), list(wrt), sizes)
    return trees, walk.lengths
