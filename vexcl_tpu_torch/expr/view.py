"""Vector views: slicing, permutation, reshape, sliced reduction.

Port of ``vexcl_tpu/expr/view.py`` (vexcl/vector_view.hpp: gslice
:264-417, range/``_`` :420-446, slicer :511-560, permutation :684-698,
expr_permutation :601-682, reduced_vector_view :708-, reshape
:1099-1125).  The JAX package gets its views from XLA, which folds
``x.reshape(dims)[key]`` and ``jnp.take`` into the fused kernel.  The port
has no XLA, so it does what VexCL's CUDA backend does: each view computes
the index it reads its inner expression at, and the emitter
(``triton_emit.Emitter``) evaluates the inner expression in that index
context (V1, the assignment kernel with indexed loads).

* ``SliceTerminal``, ``MultiSliceView`` and ``ReshapeView`` are affine:
  the index into the inner expression is ``base + sum_e i_e * coef_e``
  over the coordinates ``i_e`` of the view's output axes (an integer key
  drops an axis and moves the base; index-array keys, numpy's advanced
  indexing, share one output axis, placed where they stand when they are
  adjacent and first when a slice separates them, and read each array at
  that axis's coordinate, as the JAX package's gather: negatives wrap,
  the rest clamp).
* ``PermutationView`` (and ``pointer.PointerDeref``) read the index from
  an expression, as ``jnp.take`` of its int32 cast: negatives wrap, an
  index still out of range reads NaN (the least signed or the largest
  unsigned integer, True).
* ``ReducedView`` is not elementwise: a V2 kernel
  (``ops/triton_reduce_view.py``) writes it into a temporary first.

A view's numbers (bases, coefficients, counts, lengths) are runtime
integer leaves of the tree, so its signature holds only its structure:
rank, which keys are slices and how the arrays group.  A loop over
``indices[i]`` compiles one kernel.  Every view computes its plain
PyTorch value from the same description (``plain_index``), flat, as the
kernel reads it.

Assignment through a view (V3) is ``compile.assign_to_view``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..types import dtype_of_code
from .node import ArrayTerminal, EmitEnv, Expr, ScalarTerminal, as_expr

__all__ = [
    "SliceTerminal", "MultiSliceView", "PermutationView", "ReshapeView",
    "ReducedView", "slicer", "permutation", "reshape", "reduce_view", "r",
    "range_", "_", "SUM", "MIN", "MAX", "fill_value",
]


class _UnderscoreType:
    """vex::_ — the whole-dimension placeholder (vector_view.hpp:446)."""

    def __repr__(self):
        return "_"


_ = _UnderscoreType()


class r:
    """vex::range(start, [stride,] stop) (vector_view.hpp:420-446)."""

    def __init__(self, start=None, stride_or_stop=None, stop=None):
        if start is None:
            self.slice = slice(None)
        elif stop is None:
            self.slice = slice(start, stride_or_stop)
        else:
            self.slice = slice(start, stop, stride_or_stop)


range_ = r


def _norm_key(key) -> Tuple:
    if not isinstance(key, tuple):
        key = (key,)
    out = []
    for k in key:
        if isinstance(k, _UnderscoreType):
            out.append(slice(None))
        elif isinstance(k, r):
            out.append(k.slice)
        else:
            out.append(k)
    return tuple(out)


def _is_int(k) -> bool:
    return isinstance(k, (int, np.integer)) and not isinstance(k, bool)


def _clamp_index(k: int, d: int) -> int:
    """A static integer key as the JAX package reads it: negatives wrap,
    the rest clamp."""
    k = int(k)
    if k < 0:
        k += d
    return min(max(k, 0), d - 1)


def _index_leaf(k) -> Expr:
    """An index-array key as an expression."""
    if isinstance(k, Expr):
        return k
    if hasattr(k, "_as_terminal"):
        return k._as_terminal()
    if isinstance(k, torch.Tensor):
        return ArrayTerminal(k)
    return ArrayTerminal(np.asarray(k))


def fill_value(dtype: torch.dtype):
    """What ``jnp.take`` reads at an index out of range."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype.is_complex:
        return complex(float("nan"), 0.0)
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if dtype.is_signed else info.max


def _sized(expr: Expr, what: str) -> int:
    n = expr.size_hint()
    if n is None:
        raise ValueError(f"{what} needs a sized expression: include a "
                         "vector or give element_index an explicit length")
    return int(n)


def _unravel_plain(at: torch.Tensor, counts: Sequence[int]) -> List:
    out: List = [None] * len(counts)
    for e in range(len(counts) - 1, 0, -1):
        out[e] = at % counts[e]
        at = at // counts[e]
    if counts:
        out[0] = at
    return out


class _View(Expr):
    """A node that reads its inner expression (``children[0]``) at the
    indices it computes from the index of the element being evaluated.
    ``extent`` is the inner's length: every index read lies in
    [0, extent)."""

    _size_transparent = False
    extent: int = 0
    #: the children read at the element's own index, not beneath the view
    own_children: Tuple[int, ...] = ()

    def _sig(self, ctx) -> str:
        ctx.indexed = True
        return super()._sig(ctx)

    def _infer(self, child_codes):
        return child_codes[0]

    def emit(self, env: EmitEnv):
        idx, valid = self.plain_index(env)
        x = torch.broadcast_to(self.children[0].emit_cached(env),
                               (self.extent,))
        out = x[idx]
        if valid is not None:
            fill = torch.tensor(fill_value(out.dtype), dtype=out.dtype,
                                device=out.device)
            out = torch.where(valid, out, fill)
        return out

    def emit_src(self, em) -> str:
        tiled = em.tiled(self)
        if tiled is not None:
            return tiled
        j, mask, valid = self.emit_index(em)
        v = em.value(self.children[0], (j, mask))
        if valid is None:
            return v
        return em.where(valid, v, em.fill(em.types[id(self)]))

    def assign(self, value: Any, op: str = "=") -> "_View":
        """Write through the view into the vector it views (V3):
        ``slc[i](x).assign(e)``, ``permutation(p)(y).assign(v, "+=")``."""
        from .compile import assign_to_view

        assign_to_view(self, value, op)
        return self

    def tiled_axis(self) -> Optional[int]:
        """The axis a tiled assignment kernel loads along, or None (see
        ``_AffineView.tiled_axis``)."""
        return None

    def flat_coords(self):
        """(a, b, dims, strides, base, rounded) where the view reads its
        table (its first child) at the flat index of two coordinate
        expressions a and b, in range by construction
        (``cuda_gather.Coords``: the gather form's fused variant's
        operands; ``rounded``: float coordinates rounded, else integer
        keys wrapped); else None."""
        return None

    # the subclasses give the index: (index, valid lanes or None)
    def plain_index(self, env: EmitEnv):
        raise NotImplementedError

    def emit_index(self, em):
        """(index variable, its mask, valid-lanes variable or None) of the
        emitter's current context."""
        raise NotImplementedError


class _AffineView(_View):
    """A view whose index is ``base + sum_e i_e * coef_e`` over the
    coordinates of its output axes, row-major.  An axis keyed by index
    arrays (numpy's advanced indexing: one array, or several broadcast
    together) adds, for each array, its (wrapped and clamped) value at
    the axis's coordinate (at 0 for an array of one element) times its
    dimension's stride instead."""

    def _build(self, inner: Any, extent: int, base: int, axes) -> None:
        """``axes``: (count, coef, arrays, dim) each, where ``arrays`` is
        None for a slice, or a tuple of (index expression, coef, dim,
        its length) for an advanced axis (whose own coef and dim are
        unused)."""
        self.extent = int(extent)
        self.base = int(base)
        self.axes = [(int(c), int(coef), None if g is None else tuple(
            (a, int(k), int(dk), int(n)) for a, k, dk, n in g), int(d))
            for c, coef, g, d in axes]
        self.count = int(np.prod([a[0] for a in self.axes], dtype=np.int64))
        # one element broadcasts to every element of the assignment
        self.broadcast = self.count == 1
        arrays = [a for _, _, g, _ in self.axes if g for a, _, _, _ in g]
        params = [self.base]
        for e, (c, coef, g, d) in enumerate(self.axes):
            params += [c] if e else []
            if g is None:
                params.append(coef)
            else:
                for _, k, dk, _ in g:
                    params += [k, dk]
        self._p0 = 1 + len(arrays)
        self.children = (as_expr(inner), *arrays,
                         *(ScalarTerminal(int(p)) for p in params))

    def _struct(self) -> str:
        """Per axis: ``x`` an axis keyed by one index array of its
        length, ``[...]`` by several (``x`` each, ``x1`` one of one
        element), ``u`` a slice read with coefficient 1 (the kernels add
        its coordinate unscaled, so Triton sees the contiguity), ``a``
        another slice."""
        out = []
        for c, coef, g, _ in self.axes:
            if g is None:
                out.append("u" if coef == 1 else "a")
            elif len(g) == 1 and g[0][3] == c:
                out.append("x")
            else:
                out.append("[" + "".join("x1" if n == 1 and c != 1 else "x"
                                         for _, _, _, n in g) + "]")
        return "".join(out) + ("|b" if self.broadcast else "")

    def tiled_axis(self) -> Optional[int]:
        """The axis a tiled assignment kernel loads along
        (``triton_emit.tiled_view``): the last axis before the innermost
        one that reads with coefficient 1 where the innermost one does not
        (a transpose); None where the view is a broadcast, has an
        index-array key or fewer than two axes, or reads its innermost
        axis contiguously."""
        if self.broadcast or len(self.axes) < 2 or any(
                g is not None for _, _, g, _ in self.axes):
            return None
        unit = [coef == 1 for _, coef, _, _ in self.axes]
        if unit[-1]:
            return None
        return max((e for e in range(len(unit) - 1) if unit[e]),
                   default=None)

    def child_sizes(self, m):
        sizes = [self.extent]
        sizes += [n for _, _, g, _ in self.axes if g for _, _, _, n in g]
        return sizes + [m] * (len(self.children) - len(sizes))

    def size_hint(self) -> Optional[int]:
        return self.count

    def shape_hint(self) -> Tuple[int, ...]:
        return tuple(c for c, _, _, _ in self.axes)

    def plain_index(self, env: EmitEnv):
        device = env.device
        idx = torch.full((self.count,), self.base, dtype=torch.int64,
                         device=device)
        coords = _unravel_plain(torch.arange(self.count, device=device),
                                [c for c, _, _, _ in self.axes])
        k = 1
        for (c, coef, g, _), i in zip(self.axes, coords):
            if g is None:
                idx += i * coef
                continue
            for _, kcoef, d, n in g:
                v = torch.broadcast_to(self.children[k].emit_cached(env),
                                       (n,)).to(torch.int64)
                k += 1
                v = torch.where(v < 0, v + d, v).clamp(0, d - 1)
                idx += (v[i] if n == c else v[0]) * kcoef
        return idx, None

    def emit_params(self, em):
        """(base, counts (None for the outermost axis), coefficients,
        index-array lengths): the view's runtime integers as variables in
        the index type; for an axis keyed by index arrays, its
        coefficients and lengths are lists (one an array), for a slice
        the length is None."""
        ps = iter(self.children[self._p0:])
        base = em.param(next(ps))
        counts, coefs, dims = [], [], []
        for e, (_, _, g, _) in enumerate(self.axes):
            counts.append(em.param(next(ps)) if e else None)
            if g is None:
                coefs.append(em.param(next(ps)))
                dims.append(None)
                continue
            cs, ds = [], []
            for _ in g:
                cs.append(em.param(next(ps)))
                ds.append(em.param(next(ps)))
            coefs.append(cs)
            dims.append(ds)
        return base, counts, coefs, dims

    def emit_index(self, em):
        mask = em.at[1]
        j, counts, coefs, dims = self.emit_params(em)
        given = em.coords.get((id(self), em.at[0]))
        if self.broadcast:
            # every lane reads the one element: coordinates 0
            zero = em.define(f"tl.zeros([BLOCK], {em.ity})")
            j = em.define(f"{zero} + {j}")
            coords = [zero] * len(self.axes)
        elif given is not None:
            # the kernel computed this context's coordinates itself (V2's
            # kept and reduced axes, the tiled kernel's load order)
            coords = given
        else:
            coords = em.unravel(em.index(), counts)
        k = 1
        for (c, coef_v, g, _), i, coef, d in zip(self.axes, coords, coefs,
                                                 dims):
            if g is None:
                j = em.define(f"{j} + {i}" if coef_v == 1
                              else f"{j} + {i} * {coef}")
                continue
            for (_, _, _, n), kc, kd in zip(g, coef, d):
                at = i if n == c else em.define(f"{i} * 0")
                v = em.value(self.children[k], (at, mask))
                k += 1
                v = em.define(f"{v}.to(tl.int64)")
                v = em.define(f"tl.where({v} < 0, {v} + {kd}, {v})")
                v = em.define(f"tl.minimum(tl.maximum({v}, 0), {kd} - 1)"
                              f".to({em.ity})")
                j = em.define(f"{j} + {v} * {kc}")
        return j, mask, None


class SliceTerminal(_AffineView):
    """expr[key] over a flat expression (the 1-D gslice): a slice, an
    integer or an index array."""

    _opname = "slice"

    def __init__(self, inner: Any, key):
        inner = as_expr(inner)
        key = _norm_key(key)
        if len(key) != 1:
            raise IndexError(f"a 1-D view takes one key, not {len(key)}")
        k = key[0]
        n = _sized(inner, "a slice")
        self._static_key = key
        if isinstance(k, slice):
            start, _, step = k.indices(n)
            count = len(range(*k.indices(n)))
            self._build(inner, n, start, [(count, step, None, n)])
        elif _is_int(k):
            self._build(inner, n, _clamp_index(k, n), [])
        else:
            a = _index_leaf(k)
            m = _sized(a, "an index array")
            self._build(inner, n, 0, [(m, 0, ((a, 1, n, m),), 0)])

    def extra_sig(self) -> str:
        return self._struct()


class MultiSliceView(_AffineView):
    """N-D strided view of a flat expression: ``slicer(dims)[key](x)``
    (gslice/slicer, vector_view.hpp:264-560), ``x.reshape(dims)[key]``
    flattened.  Index arrays in the key are numpy's advanced indexing:
    they broadcast together (each of one element or of the common
    length) with the integers beside them, into one output axis that
    stands where they stand when they are adjacent, and first when a
    slice separates them."""

    _opname = "gslice"

    def __init__(self, dims: Sequence[int], key, inner: Any):
        self.dims = tuple(int(d) for d in dims)
        key = _norm_key(key)
        if len(key) > len(self.dims):
            raise IndexError(f"{len(key)} keys for {len(self.dims)} "
                             "dimensions")
        key = key + (slice(None),) * (len(self.dims) - len(key))
        self._static_key = key
        strides, stride = [], int(np.prod(self.dims, dtype=np.int64))
        for d in self.dims:
            stride //= d
            strides.append(stride)
        arrays = {e: _index_leaf(k) for e, k in enumerate(key)
                  if not isinstance(k, slice) and not _is_int(k)}
        # with an index array, the integers are advanced indices too
        adv = [e for e, k in enumerate(key)
               if e in arrays or (arrays and _is_int(k))]
        lens = {e: _sized(a, "an index array") for e, a in arrays.items()}
        count = max(lens.values(), default=1)
        if any(n not in (1, count) for n in lens.values()):
            raise IndexError("index arrays of lengths "
                             f"{sorted(set(lens.values()))} do not "
                             "broadcast together")
        base, axes = 0, []
        group = tuple((arrays[e], strides[e], self.dims[e], lens[e])
                      for e in adv if e in arrays)
        at = (adv[0] if adv == list(range(adv[0], adv[-1] + 1)) else 0) \
            if adv else None
        for e, (d, k) in enumerate(zip(self.dims, key)):
            if e == at:
                axes.append((count, 0, group, 0))
            if isinstance(k, slice):
                start, _, step = k.indices(d)
                axes.append((len(range(*k.indices(d))), step * strides[e],
                             None, d))
                base += start * strides[e]
            elif _is_int(k):
                base += _clamp_index(k, d) * strides[e]
        self._build(inner, int(np.prod(self.dims, dtype=np.int64)), base,
                    axes)

    def extra_sig(self) -> str:
        return f"{len(self.dims)}|{self._struct()}"

    def flat_coords(self):
        """A key of two index arrays of the view's length alone (one axis,
        its index wrapped and clamped on every dimension)."""
        if len(self.axes) != 1 or self.axes[0][2] is None:
            return None
        count, _, group, _ = self.axes[0]
        if len(group) != 2 or any(n != count for _, _, _, n in group):
            return None
        (a, ka, da, _), (b, kb, db, _) = group
        return a, b, (da, db), (ka, kb), self.base, False


class slicer:
    """vex::slicer<NDIM>(extents): ``slicer((n, m))[i, j](x)``."""

    def __init__(self, *dims):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list, np.ndarray)):
            dims = tuple(dims[0])
        self.dims = tuple(int(d) for d in dims)

    def __getitem__(self, key):
        dims = self.dims

        class _Bound:
            def __call__(_self, x):
                return MultiSliceView(dims, key, x)

            def __getitem__(_self, more):
                more_t = more if isinstance(more, tuple) else (more,)
                key_t = key if isinstance(key, tuple) else (key,)
                return slicer(dims).__getitem__(key_t + more_t)

        return _Bound()


class ReshapeView(_AffineView):
    """vex::reshape(expr, dst_lengths, order) (vector_view.hpp:1099-1125):
    ``out[i_0..i_k] = x[i[order[0]], i[order[1]], ...]`` with x of shape
    ``[dst[o] for o in order]``.  ``order`` a permutation of the dims is a
    transpose; a subset broadcasts along the missing output dims (their
    coefficient is 0)."""

    _opname = "reshape"

    def __init__(self, inner: Any, dst_dims: Sequence[int],
                 order: Sequence[int]):
        self.dst = tuple(int(d) for d in dst_dims)
        self.order = tuple(int(o) for o in order)
        src = [self.dst[o] for o in self.order]
        coef = [0] * len(self.dst)
        stride = 1
        for p in range(len(src) - 1, -1, -1):
            coef[self.order[p]] = stride
            stride *= src[p]
        self._build(inner, stride, 0,
                    [(d, c, None, d) for d, c in zip(self.dst, coef)])

    def extra_sig(self) -> str:
        return f"{len(self.dst)}|{self._struct()}"


def reshape(x: Any, dst_dims: Sequence[int],
            order: Optional[Sequence[int]] = None) -> ReshapeView:
    if order is None:
        order = tuple(range(len(dst_dims)))
    return ReshapeView(x, dst_dims, order)


class PermutationView(_View):
    """permutation(idx)(x): x at idx (vector_view.hpp:601-698), as
    ``jnp.take(x, idx.astype(int32))``; idx may be a vector, an array or
    an index expression (expr_permutation).  Children: the inner, the
    index, the inner's length."""

    _opname = "perm"
    own_children = (1,)

    def __init__(self, index: Any, inner: Any):
        inner = as_expr(inner)
        self.extent = _sized(inner, "a permutation")
        self.children = (inner, as_expr(index), ScalarTerminal(self.extent))

    def child_sizes(self, m):
        return [self.extent, m, m]

    def size_hint(self) -> Optional[int]:
        return self.children[1].size_hint()

    def plain_index(self, env: EmitEnv):
        j = self.children[1].emit_cached(env).to(torch.int32).to(torch.int64)
        j = torch.where(j < 0, j + self.extent, j)
        valid = (j >= 0) & (j < self.extent)
        return torch.where(valid, j, torch.zeros_like(j)), valid

    def emit_index(self, em):
        mask = em.at[1]
        n = em.param(self.children[2])
        j = em.define(f"{em.value(self.children[1])}.to(tl.int32)"
                      f".to({em.ity})")
        j = em.define(f"tl.where({j} < 0, {j} + {n}, {j})")
        valid = em.define(f"({j} >= 0) & ({j} < {n})")
        return (em.define(f"tl.where({valid}, {j}, 0)"),
                em.define(f"{mask} & {valid}"), valid)


def permutation(index: Any):
    return lambda x: PermutationView(index, x)


SUM = "sum"
MIN = "min"
MAX = "max"

_REDUCERS = ("sum", "min", "max", "prod")


def _strong(code: str) -> str:
    return {"i*": "i64", "f*": "f64", "c*": "c128"}.get(code, code)


class ReducedView(Expr):
    """vex::reduce<SUM>(view, dims): partial reduction over view axes
    (reduced_vector_view, vector_view.hpp:708-).  The result is again a
    (flattened) expression usable inside larger expressions.  Not
    elementwise: ``materialize`` runs the V2 kernel into a temporary,
    and the assignment reads that.

    Result types are ``jnp.sum``/``prod``/``min``/``max``'s with 64-bit
    types: a sum or product of booleans or signed integers is i64, of
    unsigned integers u64; min and max keep the type."""

    _size_transparent = False
    _elementwise = False
    _opname = "vreduce"

    def __init__(self, op: str, inner: Expr, axes: Sequence[int]):
        self.op = op
        inner = as_expr(inner)
        self.shape = self._shape_of(inner)
        nd = len(self.shape)
        self.axes = tuple(sorted({int(a) % nd for a in axes}))
        self.children = (inner,)

    @staticmethod
    def _shape_of(inner: Expr) -> Tuple[int, ...]:
        sh = getattr(inner, "shape_hint", None)
        sh = sh() if sh is not None else None
        if sh is None:
            sh = (_sized(inner, "reduce_view"),)
        return tuple(int(d) for d in sh)

    def extra_sig(self) -> str:
        return f"{self.op}|{self.shape}|{self.axes}"

    def _infer(self, child_codes):
        code = _strong(child_codes[0])
        if self.op in ("sum", "prod"):
            dt = dtype_of_code(code)
            if dt == torch.bool or (not dt.is_floating_point
                                    and not dt.is_complex):
                return "u64" if code in ("u8", "u16", "u32", "u64") \
                    else "i64"
        return code

    def child_sizes(self, m):
        return [int(np.prod(self.shape, dtype=np.int64))]

    def kept_shape(self) -> Tuple[int, ...]:
        return tuple(d for i, d in enumerate(self.shape)
                     if i not in self.axes)

    def size_hint(self) -> Optional[int]:
        return int(np.prod(self.kept_shape(), dtype=np.int64))

    def shape_hint(self) -> Tuple[int, ...]:
        return self.kept_shape()

    def materialize(self, device: torch.device,
                    n: Optional[int] = None) -> torch.Tensor:
        from ..ops.triton_reduce_view import reduce_view_eval

        return reduce_view_eval(self, device)

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)


def reduce_view(op: Any, view: Any, axes) -> ReducedView:
    """``reduce_view("sum", slc[:, :](x), 1)``: ``op`` one of sum, min,
    max, prod (any case, or a Reductor kind), ``axes`` an int or a
    sequence of the view's axes; a ``multi_array`` reduces its whole
    view."""
    if isinstance(axes, (int, np.integer)):
        axes = (int(axes),)
    if not isinstance(view, Expr) and callable(getattr(view, "view", None)):
        view = view.view()  # vex::reduce(multi_array, dims)
    op = str(getattr(op, "name", op)).lower()
    if op not in _REDUCERS:
        raise ValueError(f"unknown reduction {op!r}; one of "
                         f"{sorted(_REDUCERS)}")
    return ReducedView(op, view, axes)
