"""Expression-fused reductions: SUM / MIN / MAX / Kahan / combined.

Port of ``vexcl_tpu/ops/reductor.py`` (vexcl/reductor.hpp: reduction ops
:47-128, CombineReductors :133-280, Reductor::operator() :302-439,
Kahan codegen :537-564).  ``Sum(x * y)`` evaluates the expression and
reduces it in one pass of the map-reduce kernel (``triton_reduce.py``);
an SpMV inside the expression is computed first into a temporary, as
for an assignment.

One kind over one expression is one launch of ``map_reduce``; several
kinds (``MIN_MAX``, ``CombineReductors``), ``SUM_Kahan`` and the
components of a multivector (a tuple, one result per component, as the
reference's ``std::array``) are one launch of ``map_reduce_multi``,
every (component, kind) an accumulator of it.  On CPU tensors the plain
PyTorch reductions run instead.  The shard_map local phase and the
psum/pmin/pmax combine of the JAX package are gone with the mesh.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from ..expr.compile import prepare_multi
from ..expr.node import CastExpr, analyze, as_expr, expression_properties
from ..types import dtype_of
from ..utils.util import ExpressionError
from .triton_reduce import map_reduce, map_reduce_multi

__all__ = ["SUM", "MIN", "MAX", "SUM_Kahan", "MIN_MAX", "CombineReductors",
           "Reductor"]


class ReductionKind:
    """One reduction operation (reductor.hpp:47-128)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"<reduction {self.name}>"


SUM = ReductionKind("SUM")
MIN = ReductionKind("MIN")
MAX = ReductionKind("MAX")
SUM_Kahan = ReductionKind("SUM_Kahan")


def CombineReductors(*kinds: ReductionKind) -> Tuple[ReductionKind, ...]:
    """Several reductions over one expression (reductor.hpp:133-280)."""
    return tuple(kinds)


MIN_MAX = CombineReductors(MIN, MAX)


class Reductor:
    """``Reductor(SUM)`` / ``Reductor(torch.float64, SUM)``; call it on
    any expression::

        Sum = vex.Reductor(vex.SUM)
        s = Sum(x * y)            # fused multiply + reduce, one kernel
    """

    def __init__(self, arg0: Any = None, arg1: Any = None, *, context=None):
        if isinstance(arg0, (ReductionKind, tuple)):
            self.kinds = arg0
            self.dtype = dtype_of(arg1) if arg1 is not None else None
        else:
            self.dtype = dtype_of(arg0) if arg0 is not None else None
            self.kinds = arg1 if arg1 is not None else SUM
        self.context = context
        self._combined = isinstance(self.kinds, tuple)

    def __call__(self, expr: Any) -> Union[float, int, Tuple]:
        multi = getattr(expr, "_multi", False)
        if multi:
            from ..multivector import parts

            bodies = parts(expr)
        else:
            bodies = [as_expr(expr)]
        n, ctx = expression_properties(bodies[0])
        if n is None:
            raise ExpressionError(
                analyze(bodies[0]).sig,
                ValueError("Reductor: expression has no sized terminal — "
                           "include a vector or give element_index an "
                           "explicit length"))
        if self.dtype is not None:
            bodies = [CastExpr(self.dtype, b) for b in bodies]
        ctx = self.context or ctx
        if ctx is None:
            from ..context import current_context

            ctx = current_context()
        device = ctx.device
        kinds = self.kinds if self._combined else (self.kinds,)
        bodies, analysis, types, leaves = prepare_multi(bodies, n, device)
        pairs = [(b, k.name) for b in bodies for k in kinds]
        if len(pairs) == 1 and kinds[0] is not SUM_Kahan:
            res = [map_reduce(bodies[0], analysis, types, leaves, n,
                              kinds[0].name, device)]
        else:
            res = map_reduce_multi(pairs, analysis, types, leaves, n, device)
        # one transfer where the results came back as one tensor
        vals = (res.tolist() if isinstance(res, torch.Tensor)
                else [r.item() for r in res])
        k = len(kinds)
        per = [tuple(vals[i * k:(i + 1) * k]) if self._combined else vals[i]
               for i in range(len(bodies))]
        return tuple(per) if multi else per[0]
