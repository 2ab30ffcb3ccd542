"""vexcl_tpu_torch — the PyTorch/CUDA port of vexcl_tpu.

The same API as ``vexcl_tpu`` for the slice ported so far: lazy vector
expressions, each assignment one generated Triton kernel; the Reductor
(SUM/MIN/MAX) on a Triton map-reduce kernel; ``SpMat`` in every format
(DIA, CSR, ELL, hybrid, SELL-R) and ``SpMatCCSR`` on hand-written CUDA
kernels (DIA, SELL-C-sigma, CSR-vector); ``stencil`` on a CUDA stencil
kernel and ``StencilOperator`` on the expression kernel; and CG solves
built on them.  On CPU tensors every kernel's plain PyTorch version runs
instead.  This package imports neither ``jax`` nor ``vexcl_tpu``::

    import vexcl_tpu_torch as vex

    ctx = vex.Context(vex.Filter.GPU)
    x, y, z = (vex.vector(n) for _ in range(3))
    x[:] = 2 * y + vex.sin(z)

    Sum = vex.Reductor(vex.SUM)
    s = Sum(x * x)
"""

from __future__ import annotations

from .config import config
from .cache import ObjectCache, kernel_cache, purge_caches
from .context import Context, Filter, current_context, make_context
from .types import dtype_of, promote, type_name
from .vector import vector
from .expr import (BUILTINS, Expr, as_expr, builtin, cast, constant,
                   element_index, eval_expr as eval, if_else, make_temp, tag)
from .expr import mathconst as constants
from .expr.builtins import *  # noqa: F401,F403 - sin, cos, exp, ...
from .ops.reductor import (MAX, MIN, MIN_MAX, SUM, SUM_Kahan,
                           CombineReductors, Reductor)
from .sparse import SpMat, SpMatCCSR, make_inline, matrix
from .ops.stencil import StencilOperator, stencil, stencil_operator
from . import interop
from .utils.util import ExpressionError, alignup, nextpow2, precondition

__version__ = "0.1.0"
