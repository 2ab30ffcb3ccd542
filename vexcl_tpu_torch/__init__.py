"""vexcl_tpu_torch — the PyTorch/CUDA port of vexcl_tpu.

The same API as ``vexcl_tpu`` for the slice ported so far: lazy vector
expressions, each assignment one generated Triton kernel; the Reductor
(SUM/MIN/MAX, ``SUM_Kahan``, ``CombineReductors``, per component of a
multivector) on a Triton map-reduce kernel; ``multivector`` and ``tie``,
each fused assignment one generated Triton kernel writing k outputs, and
on it user ``function``s, the symbolic ``generator`` and the Lorenz RK4
ensemble; ``SpMat`` in every format
(DIA, CSR, ELL, hybrid, SELL-R) and ``SpMatCCSR`` on hand-written CUDA
kernels (DIA, SELL-C-sigma, row-block CSR); ``stencil`` on a CUDA stencil
kernel and ``StencilOperator`` on the expression kernel; the scan family
(``inclusive_scan``, ``exclusive_scan``, their ``_by_key`` forms and
``reduce_by_key``) on CUDA scan and stream-compaction kernels, and
``sort``/``sort_by_key``; counter-based random numbers inside expressions
(``Random``, ``RandomNormal``: Philox and Threefry fused into the
expression kernels, and the ``"hw"`` generator on a CUDA Philox kernel)
with the Monte-Carlo models; the runtime (``CustomKernel`` over user CUDA
C++ and Triton kernels, ``events``/``enqueue``, ``profiler``,
``stopwatch``, dlpack interop); CG and BiCGStab solves built on them;
and the views (``slicer``, ``permutation``, ``reshape``, ``raw_pointer``,
``multi_array``; slices and index arrays of a vector) as indexed loads and
stores of the generated kernels, ``reduce_view`` on a generated
reduction kernel, atomic updates through a permutation, ``tensordot``,
``gather``/``scatter`` and ``any_of``/``all_of``; complex vectors in
the generated kernels ((re, im) pairs: ``conj``, ``real``, ``imag``,
``abs``), ``FFT``/``fft``/``ifft`` (cuFFT, or the ported Cooley-Tukey
engine) and ``mba`` (a host fit, its evaluation fused into the
assignment kernel); every builtin of ``vexcl_tpu`` (integer helpers,
``select``, the pairs, the geometric helpers), integer ``**`` and
boolean arithmetic in the generated kernels, numpy's advanced indexing
in slicer keys, ``image1d``/``image2d`` samples (their taps fused into
the assignment kernel), ``svm_vector`` and ``Filter.Exclusive``.
On CPU tensors every kernel's plain PyTorch version runs instead.  The default context
is a CUDA device: the CPU runs where it is asked for (``Filter.CPU``,
``device="cpu"`` or ``VEXTPU_PLATFORM=cpu``).  This package imports neither ``jax`` nor ``vexcl_tpu``::

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
from .expr.function import Function, device_function, function
from .multivector import MultiExpr, multivector, tie
from .ops.reductor import (MAX, MIN, MIN_MAX, SUM, SUM_Kahan,
                           CombineReductors, Reductor)
from .sparse import SpMat, SpMatCCSR, make_inline, matrix
from .ops.stencil import StencilOperator, stencil, stencil_operator
from .ops.scan import exclusive_scan, inclusive_scan
from .ops.scan_by_key import exclusive_scan_by_key, inclusive_scan_by_key
from .ops.reduce_by_key import reduce_by_key
from .ops.sort import sort, sort_by_key
from .ops.random import Random, RandomNormal
from .ops.fft import FFT, fft, ifft
from .ops.mba import mba
from .ops.image import image1d, image2d, svm_vector
from .expr.view import (MultiSliceView, PermutationView, ReducedView,
                        ReshapeView, SliceTerminal, _, permutation, r,
                        range_, reduce_view, reshape, slicer)
from .expr.pointer import constant_pointer, raw_pointer
from .ndarray import extents, indices, multi_array
from .ops.tensordot import axes_pairs, tensordot
from .ops.atomic import atomic_add, atomic_max, atomic_min, atomic_sub
from .ops.gather import Gather, Scatter, gather, scatter
from .ops.logical import all_of, any_of
from .vector import copy, partition
from .profiler import profiler, stopwatch
from . import backend, events, generator, interop
from .generator import symbolic
from .backend import CustomKernel
from .events import enqueue, enqueue_barrier, enqueue_marker
from .utils.util import ExpressionError, alignup, nextpow2, precondition

__version__ = "0.1.0"
