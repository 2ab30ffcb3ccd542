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
* every other node whose adjoint needs another kernel (a view with an
  index map, ``PointerDeref``, the SpMV, reductions, FFT, MBA, images,
  random numbers) raises ``NotImplementedError`` naming the node, and
  only when a gradient is asked through it.  Complex values raise too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..types import dtype_of_code
from .builtins import BUILTINS, GRADIENTS, _expands, _k
from .node import (BinOp, CastExpr, Expr, FuncCall, Temporary, UnOp,
                   Where, _Op)

__all__ = ["adjoint"]


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
        return node.infer(self.types)

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
             wrt: Sequence[Expr]) -> List[Optional[Expr]]:
        """The adjoint of each of ``wrt`` (None where no path reaches it)
        given the cotangent of each root."""
        stop = {id(w) for w in wrt}
        order, depends = self._order(roots, stop)
        bar: Dict[int, Expr] = {}

        def add(node: Expr, g: Optional[Expr]) -> None:
            if g is None or id(node) not in depends \
                    or not self.is_float(node):
                return
            g = self.cast(g, self.code(node))
            self.keep.append(g)
            prev = bar.get(id(node))
            bar[id(node)] = g if prev is None else BinOp("add", prev, g)

        for r, c in zip(roots, cots):
            add(r, c)
        for node in reversed(order):
            g = bar.get(id(node))
            if g is None or id(node) in stop:
                continue
            for child, contrib in zip(node.children,
                                      self.contributions(node, g)):
                add(child, contrib)
        return [bar.get(id(w)) for w in wrt]

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

    def contributions(self, node: Expr, g: Expr):
        """One contribution of ``g`` per child of ``node``."""
        if isinstance(node, Where):
            zero = _k(0.0)
            c = node.children[0]
            return None, Where(c, g, zero), Where(c, zero, g)
        if isinstance(node, (CastExpr, Temporary)):
            return (g,)
        if isinstance(node, (BinOp, UnOp, FuncCall)):
            return self._op(node, g)
        raise NotImplementedError(
            f"no gradient through {_describe(node)}: its adjoint needs a "
            "kernel of its own (a gather's is a scatter, a reduction's a "
            "broadcast), which the backward kernel does not have")

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
            wrt: Sequence[Expr], types: Dict[int, str]
            ) -> List[Optional[Expr]]:
    """The adjoint tree of each of ``wrt`` (a parameter leaf of the trees
    ``roots``) given one cotangent leaf per root (None: no cotangent),
    each in its parameter's type; None where no path from a root with a
    cotangent reaches it.  ``types`` holds the codes of the trees' nodes
    (``node.infer_types``, the parameters and the cotangents bound) and
    receives those of the nodes built."""
    return _Adjoint(types).walk(list(roots), list(cotangents), list(wrt))
