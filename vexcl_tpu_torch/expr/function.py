"""User-defined device functions.

Port of ``vexcl_tpu/expr/function.py`` (the VEX_FUNCTION macro family,
vexcl/function.hpp:146-243, and proto UserFunction, operations.hpp:575-628).
The reference splices user-written source into the generated kernel; the
JAX package traces a Python function over JAX values into the fused
kernel.  Here the user writes a Python function with operators and the
package's builtins, and

* called on expressions (vectors, symbolic values, trees), the function's
  body runs on the expression arguments and returns an expression tree,
  which becomes part of the caller's tree: the generated kernel inlines
  it, and nothing runs outside the kernel;
* called on plain numbers or tensors, it runs eagerly
  (``squared_radius(3.0, 4.0) == 25``, VEX_DUAL_FUNCTOR);
* called on a multivector, it applies componentwise.

A body that cannot run on expressions (``math.sin(x)``, a call to numpy)
raises ``TypeError`` naming the function: there is no plain evaluation to
fall back to on the card.  Functions calling functions need no
declaration (VEX_FUNCTION_D).
"""

from __future__ import annotations

from typing import Callable

from .node import Expr, as_expr

__all__ = ["function", "Function", "device_function"]


class Function:
    """``Function("rad2", lambda x, y: x*x + y*y)``: a named device
    function usable in expressions and on plain values."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn
        self.__name__ = name

    def __call__(self, *args):
        if any(getattr(a, "_multi", False) for a in args):
            from ..multivector import lift

            return lift(self, args)
        if not any(isinstance(a, Expr) or hasattr(a, "_as_terminal")
                   for a in args):
            return self.fn(*args)
        try:
            return as_expr(self.fn(*[as_expr(a) for a in args]))
        except (TypeError, AttributeError) as err:
            raise TypeError(
                f"device function {self.name!r}: its body does not build an "
                f"expression from expression arguments ({err}); write it "
                "with operators and the package's builtins") from err

    def __repr__(self):
        return f"<device function {self.name}>"


def function(fn: Callable = None, *, name: str = None):
    """Decorator turning a Python function into an expression-capable
    device function::

        @vex.function
        def squared_radius(x, y):
            return x * x + y * y

        r2[:] = squared_radius(x, y)          # lazy, fused
        assert squared_radius(3.0, 4.0) == 25 # eager (dual functor)
    """

    def wrap(f: Callable) -> Function:
        return Function(name or f.__name__, f)

    if fn is None:
        return wrap
    return wrap(fn)


device_function = function
