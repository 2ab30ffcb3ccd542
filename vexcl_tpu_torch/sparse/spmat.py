"""SpMat / sparse.matrix / SpMatCCSR — sparse matrices as expression
terminals.

Port of ``vexcl_tpu/sparse/spmat.py`` (vexcl/spmat.hpp:57-398,
vexcl/sparse/matrix.hpp:28-150, vexcl/spmat/inline_spmv.hpp:43-70,
vexcl/spmat/ccsr.hpp:54-280).  ``A * x`` is an ``SpMVExpr`` node: inside
any expression it is computed first by the format's kernel into a
temporary (its x, when x is itself an expression, by the expression
kernel), and the elementwise kernel then reads that temporary as a
leaf, so ``x[:] = A * x`` reads the old x::

    A = vex.SpMat(n, n, ptr, col, val)   # DIA if banded, else the default
    y[:] = A * x
    y[:] = 0.5 * (A * x) + y             # SpMV, then one fused kernel

Format policy (``spmat.py:141-201`` of the JAX package): ``fmt=None``
tries DIA first; a matrix DIA does not fit gets ``default_format`` of the
context's device type: ``"csr"`` on a CPU and on CUDA.  On the card the
row-block CSR kernel beats the SELL kernel on the bench's irregular
matrix in f32 and f64 (the timings in turns of ``chip_smoke.py``'s phase
6; PERF.md), so the JAX package's accelerator default, SELL-R, is taken
only on request (``fmt="sellr"``).  An explicit ``fmt`` in ``FORMATS``
works on both.  Two parts of the JAX policy are TPU workarounds and are
not ported: the f64 guard that sends f64 matrices to ``"hyb"`` (v5e has
no f64); and the warning about the TPU's gather speed.

A vector-valued matrix (``val`` of shape (nnz, k), the reference's
``cl_double2`` values, tests/spmv.cpp:440-530) is k scalar matrices, one
per value plane, applied to the k components of a multivector; a scalar
matrix applied to a multivector applies to each component.  Each
component's product is one launch of its format's kernel, hoisted before
the fused assignment that reads it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..config import config
from ..context import current_context
from ..expr.compile import evaluate
from ..expr.node import EmitEnv, Expr, VectorTerminal, as_expr
from .cuda_dia import dia_matvec
from .dia import DIA, _bf16_exact, try_build_dia
from .formats import from_csr_host

__all__ = ["SpMat", "SpMatCCSR", "SpMVExpr", "CCSRExpr", "FORMATS",
           "default_format", "make_inline", "matrix"]

#: the formats ``SpMat(fmt=...)`` takes
FORMATS = ("csr", "ell", "hyb", "sellr", "dia")


def default_format(device_type: str) -> str:
    """Format of a matrix that DIA does not fit, on a device of this type
    (sparse/matrix.hpp:28-150: CSR on CPUs, the fast format on GPUs; on
    the H100 that is the row-block CSR kernel, see the module doc)."""
    if device_type in ("cpu", "cuda"):
        return "csr"
    raise NotImplementedError(f"no sparse format for {device_type} devices")


def _products(mat, x, node):
    """``mat * x`` as an expression: with a multivector (or a multivector
    expression) x, a ``MultiExpr`` of one product per component, plane c
    of a vector-valued matrix on component c."""
    comps = mat._components
    if not getattr(x, "_multi", False):
        if comps is not None:
            raise TypeError("a vector-valued matrix is applied to a "
                            "multivector")
        return node(mat, x)
    from ..multivector import MultiExpr, parts

    xs = parts(x)
    if comps is not None and len(comps) != len(xs):
        raise ValueError(f"matrix with {len(comps)}-component values applied "
                         f"to a {len(xs)}-component multivector")
    return MultiExpr([node(a, xc) for a, xc in
                      zip(comps or [mat] * len(xs), xs)])


class SpMVExpr(Expr):
    """A * x as an expression node."""

    _size_transparent = False
    _elementwise = False
    _opname = "spmv"

    def direct_dtype(self) -> Optional[torch.dtype]:
        """The product's type where ``materialize`` writes it straight
        into an ``out`` (a DIA matrix times a vector of the product's
        type), else None."""
        x = self.children[0]
        if (type(self.mat) is SpMat and isinstance(self.mat.device, DIA)
                and isinstance(x, VectorTerminal)
                and self.mat.device.result_dtype(x.vec.dtype)
                == x.vec.dtype):
            return x.vec.dtype
        return None

    def __init__(self, mat, x: Any):
        self.mat = mat
        self.children = (as_expr(x),)

    def extra_sig(self) -> str:
        m = self.mat
        if isinstance(m.device, DIA):
            extra = hash(m.device.offsets)
        else:
            extra = int(getattr(m.device, "tail", None) is not None)
        return f"{m.device.format}:{m.n}:{extra}"

    def materialize(self, device: torch.device, n: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A x through the format's kernel (x evaluated first if needed);
        into ``out`` where it is given (``compile.evaluate``'s direct
        path: a target of the product's type and length that x does not
        read)."""
        x = self.children[0]
        if isinstance(x, VectorTerminal):
            xt = x.vec.storage
        else:
            xt = evaluate(x, n=self.mat.m)
        if xt.device != device:
            raise ValueError(f"SpMV operand on {xt.device}, evaluation on "
                             f"{device}")
        return (self.mat._matvec(xt) if out is None
                else self.mat._matvec(xt, out))

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)

    def size_hint(self) -> Optional[int]:
        return self.mat.n


class SpMat:
    """Sparse matrix from host CSR arrays (spmat.hpp:57-379)::

        A = vex.SpMat(n, m, ptr, col, val)          # or fmt="csr", ...
        y[:] = A * x
    """

    def __init__(self, n: int, m: Optional[int] = None, ptr=None, col=None,
                 val=None, *, fmt: Optional[str] = None, context=None):
        self.context = context or current_context()
        if m is None:
            m = n
        self.n, self.m = int(n), int(m)
        self._components = None
        if val is not None and np.ndim(val) == 2:
            val = np.asarray(val)
            self._components = tuple(
                SpMat(n, m, ptr, col, np.ascontiguousarray(val[:, c]),
                      fmt=fmt, context=self.context)
                for c in range(val.shape[1]))
            self.device = self._components[0].device
            return
        if fmt is not None and fmt not in FORMATS:
            raise ValueError(f"unknown sparse format {fmt!r}")
        dev = self.context.device
        if fmt is None:
            self.device = try_build_dia(self.n, self.m, ptr, col, val,
                                        device=dev)
            if self.device is not None:
                return
            fmt = default_format(dev.type)
        if fmt == "dia":
            self.device = try_build_dia(self.n, self.m, ptr, col, val,
                                        max_diags=1 << 30, min_fill=0.0,
                                        device=dev)
            if self.device is None:
                raise ValueError("matrix has no entries; cannot build DIA")
        else:
            self.device = from_csr_host(self.n, self.m, ptr, col, val, fmt,
                                        device=dev)

    @property
    def nnz(self) -> int:
        return self.device.nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.device.dtype

    def _matvec(self, x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A x; into ``out`` where it is given, which only a DIA matrix's
        product is (``SpMVExpr.direct_dtype``)."""
        return self.device.apply(x) if out is None else self.device.apply(
            x, out)

    def __mul__(self, x):
        return _products(self, x, SpMVExpr)

    matvec = __mul__

    def apply(self, x, y, alpha: float = 1.0, append: bool = False) -> None:
        """SpMat::apply (spmat.hpp:120-185): y = alpha*A*x (+ y)."""
        y.assign(alpha * self.matvec(x), "+=" if append else "=")

    def __repr__(self) -> str:
        return (f"SpMat<{self.dtype}>[{self.n}x{self.m}] nnz={self.nnz} "
                f"fmt={self.device.format}")


class CCSRExpr(SpMVExpr):
    """A * x for a ``SpMatCCSR``."""

    _opname = "ccsr"

    def extra_sig(self) -> str:
        cached = "c" if self.mat.cached_coeffs is not None else ""
        return f"{self.mat.n}:{self.mat.width}{cached}"


_CCSR_PAD = np.int32(-(2**31) + 1)

#: a pattern offset union up to this size takes the banded (DIA) path
_UNION_MAX = 64


class SpMatCCSR:
    """Compressed CSR: rows sharing one pattern of offsets and values
    store it once (spmat/ccsr.hpp:54-280), as for regular-grid stencil
    matrices.  ``idx[i]`` selects the pattern of row i; ``row/col/val``
    are the CSR of the unique patterns, with columns as offsets from the
    row index.

    When the union of all pattern offsets is small (at most 64) the
    matrix is banded: a (nuniq, d) coefficient table aligned to the union
    expands, by a gather of its rows by ``idx``, into DIA planes that the
    DIA kernel applies.  ``cache_expansion`` keeps those planes: ``None``
    (AUTO) when they fit ``config.ccsr_cache_mb`` (counted at bf16 width
    when the table is bf16-exact), ``True`` always, ``False`` never (each
    product then expands again).  Cached f32 planes that bf16 holds
    exactly are stored as bf16.  A wider union takes the general path, a
    plain PyTorch gather over the per-row patterns, as the JAX package
    leaves it to an XLA gather outside any kernel.
    """

    def __init__(self, n: int, m: Optional[int], idx, row, col, val, *,
                 context=None, cache_expansion: Optional[bool] = None):
        self._components = None
        if np.ndim(val) == 2:
            val = np.asarray(val)
            self._components = tuple(
                SpMatCCSR(n, m, idx, row, col,
                          np.ascontiguousarray(val[:, c]), context=context,
                          cache_expansion=cache_expansion)
                for c in range(val.shape[1]))
            # shape, pattern and type are the first plane's
            self.__dict__.update(vars(self._components[0]),
                                 _components=self._components)
            return
        idx = np.asarray(idx, dtype=np.int32)
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val)
        lens = np.diff(row)
        nuniq, nnz = len(lens), int(row[-1])
        width = int(lens.max(initial=0))
        pat = np.repeat(np.arange(nuniq, dtype=np.int64), lens)
        j = np.arange(nnz, dtype=np.int64) - row[pat]
        off = np.full((nuniq, width), _CCSR_PAD, dtype=np.int32)
        off[pat, j] = col[:nnz]
        pval = np.zeros((nuniq, width), dtype=val.dtype)
        pval[pat, j] = val[:nnz]
        union = table = None
        uni = np.unique(col[:nnz])
        if len(uni) <= _UNION_MAX:
            table = np.zeros((nuniq, len(uni)), dtype=val.dtype)
            # duplicates on one offset sum (CSR semantics)
            np.add.at(table, (pat, np.searchsorted(uni, col[:nnz])),
                      val[:nnz])
            union = uni
        self._setup(n, m, idx, off, pval, union, table, context)
        self.nnz = nnz
        if cache_expansion is None and union is not None:
            itemsize = (2 if table.dtype == np.float32 and _bf16_exact(
                torch.from_numpy(table)) else table.dtype.itemsize)
            cache_expansion = (len(union) * self.n * itemsize
                               <= config.ccsr_cache_mb * (1 << 20))
        if cache_expansion and union is not None:
            coeffs = self._expand()
            if coeffs.dtype == torch.float32 and _bf16_exact(coeffs):
                coeffs = coeffs.to(torch.bfloat16)
            self.cached_coeffs = coeffs

    def _setup(self, n, m, idx, off, pval, union, table, context) -> None:
        from ..vector import host_tensor

        self.context = context or current_context()
        dev = self.context.device
        self.n = int(n)
        self.m = int(m) if m is not None else int(n)
        self.idx = host_tensor(np.asarray(idx, dtype=np.int32)).to(dev)
        self.off = host_tensor(np.asarray(off, dtype=np.int32)).to(dev)
        self.pval = host_tensor(pval).to(dev)
        self.width = int(self.off.shape[1])
        self.nnz = int((self.off != int(_CCSR_PAD)).sum())
        if union is None:
            self.offset_union = self.union_dev = self.union_table = None
        else:
            self.offset_union = tuple(int(o) for o in union)
            self.union_dev = torch.tensor(self.offset_union,
                                          dtype=torch.int64, device=dev)
            self.union_table = host_tensor(table).to(dev)
        self.cached_coeffs = None

    @classmethod
    def from_arrays(cls, n: int, m: Optional[int], idx, off, pval,
                    offset_union=None, union_table=None, cached_coeffs=None,
                    *, context=None) -> "SpMatCCSR":
        """From a JAX package SpMatCCSR's state as numpy arrays: its
        leaves (idx, off, val), ``offset_union`` with the union table,
        and the cached coefficient planes (bf16 planes stay bf16)."""
        from ..vector import host_tensor

        obj = cls.__new__(cls)
        obj._components = None
        obj._setup(n, m, idx, off, pval, offset_union, union_table, context)
        if cached_coeffs is not None:
            obj.cached_coeffs = host_tensor(cached_coeffs).to(
                obj.context.device).contiguous()
        return obj

    @property
    def dtype(self) -> torch.dtype:
        return self.pval.dtype

    def _expand(self) -> torch.Tensor:
        """The (d, n) DIA planes: the union table gathered by idx."""
        return self.union_table.t().index_select(1, self.idx.long()) \
            .contiguous()

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.offset_union is not None:
            coeffs = (self.cached_coeffs if self.cached_coeffs is not None
                      else self._expand())
            return dia_matvec(self.n, self.m, self.offset_union,
                              self.union_dev, coeffs, x)
        # general path: per-row pattern planes and a gather
        rows = self.idx.long()
        row_off = self.off[rows]                            # (n, w)
        row_val = self.pval[rows]
        cols = torch.arange(self.n, device=x.device)[:, None] + row_off
        mask = (row_off != int(_CCSR_PAD)) & (cols >= 0) & (cols < self.m)
        gathered = x[torch.where(mask, cols, 0)]
        prod = row_val * gathered
        return torch.where(mask, prod, torch.zeros((), dtype=prod.dtype,
                                                   device=x.device)).sum(1)

    def __mul__(self, x):
        return _products(self, x, CCSRExpr)

    def apply(self, x, y, alpha: float = 1.0, append: bool = False) -> None:
        y.assign(alpha * (self * x), "+=" if append else "=")


def make_inline(expr):
    """vex::make_inline (spmat/inline_spmv.hpp:43-70): the identity."""
    return expr


def matrix(*args, **kwargs) -> SpMat:
    """sparse::matrix (sparse/matrix.hpp): the backend's format."""
    return SpMat(*args, **kwargs)
