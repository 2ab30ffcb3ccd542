"""Image terminals and mapped vectors.

Port of ``vexcl_tpu/ops/image.py`` (vexcl/image.hpp with
backend/cuda/texture_object.hpp, and vexcl/svm_vector.hpp).

* ``image1d``, ``image2d``: a read-only table sampled inside expressions,
  ``img(x)`` and ``img(x, y)``, nearest (``jnp.round``: half to even) or
  linear with clamp-to-edge addressing; a linear sample clamps its
  coordinates into the image first, as the JAX package does.  A sample
  is one node over the flat table and the coordinates, whose kernel form
  writes the clamps, the taps (loads of the table at computed indices)
  and the lerp into the assignment kernel (V1), as MBA's taps were before
  their CUDA kernel.  The reference binds a texture object; the port
  reads the table through the L1 and L2 caches, which serve the same
  purpose on the H100.  The JAX package's bilinear patch table (four
  texels a row, one row gather a sample; ``VEXTPU_IMG_PATCH_MB``) is not
  ported: it exists because TPU gathers are bound by the count of
  indices, which the card's are not.
* ``svm_vector``: a vector with the reference's map/unmap protocol over a
  host mirror: ``map()`` copies the vector to the host, ``unmap()`` writes
  the mirror back, and ``with v as host:`` does both.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..context import current_context
from ..expr.node import ArrayTerminal, EmitEnv, as_expr
from ..expr.view import _View
from ..types import COMPLEX_CODES, dtype_of_code, real_code
from ..vector import vector

__all__ = ["image1d", "image2d", "svm_vector"]

_FILTERS = ("nearest", "linear")
#: the assignment kernel's (BLOCK, warps) over a linear sample: one
#: element a thread.  2^24 bilinear samples of a 4096^2 f32 image took
#: 0.765 ms at this shape on an H100 SXM (700 W), 0.962 at the default
#: (1024, 4); nearest ones gain 1% (``scripts/torch_image_shapes.py``)
_LINEAR_SHAPE = (256, 8)


def _concrete(code: str) -> str:
    """A coordinate's compute code: a weak one's wide type, a boolean's
    integer one (``jnp.clip`` of a boolean is an integer)."""
    return {"f*": "f64", "i*": "i64", "b1": "i64"}.get(code, code)


class ImageSample(_View):
    """``img(x)`` or ``img(x, y)``: one node over the flat table and the
    coordinate expressions (children: the table, x[, y]).  The plain form
    computes the JAX package's formula; the kernel form writes the clamps,
    the taps (loads of the table at computed indices, V1) and the lerp
    into the assignment kernel's source.  The result has the table's
    type; a linear sample of booleans is an integer (jnp's ``1 - t``)."""

    _opname = "img"
    #: x and y are read at the element's own index, the table beneath
    own_children = (1, 2)

    def __init__(self, img: "_Image", *coords: Any):
        self.img = img
        self.children = (img._table,) + tuple(as_expr(c) for c in coords)
        if img.filter == "linear":
            self.kernel_shape = _LINEAR_SHAPE

    def extra_sig(self) -> str:
        return f"{self.img.filter}:{self.img.shape}"

    def _infer(self, child_codes):
        if self.img.filter == "linear" and child_codes[0] == "b1":
            return "i*"
        return child_codes[0]

    def child_sizes(self, m):
        return [int(self.img.data.numel())] + [m] * (len(self.children) - 1)

    def size_hint(self) -> Optional[int]:
        for c in self.children[1:]:
            n = c.size_hint()
            if n is not None:
                return n
        return None

    # -- the plain form ---------------------------------------------------
    def emit(self, env: EmitEnv):
        tab = self.children[0].emit_cached(env)
        coords = [self._coord(env, c) for c in self.children[1:]]
        dims = self.img.shape[::-1]           # x along the last axis
        if self.img.filter == "nearest":
            idx = [torch.round(c).to(torch.int32) if c.is_floating_point()
                   else c.to(torch.int32) for c in coords]
            return _take(tab, self._flat(idx, dims))
        rc = env.types[id(self)]
        code = env.types[id(self.children[0])]
        cdt = dtype_of_code(rc)
        wide = not (cdt.is_floating_point or cdt.is_complex)
        i0, i1, t = [], [], []
        for c, d in zip(coords, dims):
            c = torch.clamp(c, 0, d - 1)
            c0 = torch.floor(c) if c.is_floating_point() else c
            w = (c - c0).to(dtype_of_code(real_code(code)))
            # integer results: in i64 (PyTorch's CPU kernels lack most
            # operations on u16, u32 and u64), narrowed at the end
            t.append(w.to(torch.int64 if wide else dtype_of_code(
                real_code(rc))))
            i0.append(c0.to(torch.int32))
            i1.append(c0.to(torch.int32) + 1)
        taps = [_take(tab, self._flat(ix, dims))
                for ix in self._corners(i0, i1)]
        if wide:
            taps = [v.view(torch.int64) if v.dtype == torch.uint64
                    else v.to(torch.int64) for v in taps]
        out = self._lerp(taps, t)
        if wide:
            return (out.view(torch.uint64) if cdt == torch.uint64
                    else out.to(cdt))
        return out

    @staticmethod
    def _coord(env: EmitEnv, c) -> torch.Tensor:
        v = c.emit_cached(env)
        return v.to(torch.int64) if v.dtype == torch.bool else v

    @staticmethod
    def _flat(idx: Sequence[torch.Tensor], dims) -> torch.Tensor:
        """The flat table index of coordinates (x first), each clamped
        into the image."""
        return sum(torch.clamp(i, 0, d - 1).to(torch.int64) * s
                   for i, d, s in zip(idx, dims, _strides(dims)))

    @staticmethod
    def _corners(i0: List, i1: List) -> List[List]:
        """The taps' coordinates (x first), in the lerp's order: x0 then
        x1 in the first row, then the second row."""
        if len(i0) == 1:
            return [[i0[0]], [i1[0]]]
        return [[i0[0], i0[1]], [i1[0], i0[1]], [i0[0], i1[1]],
                [i1[0], i1[1]]]

    @staticmethod
    def _lerp(taps: List, t: List):
        """The JAX package's sum, term by term in its order:
        v0 (1 - tx) + v1 tx; in 2-D each term also times (1 - ty) or
        ty."""
        u = [1 - w for w in t]
        if len(t) == 1:
            return taps[0] * u[0] + taps[1] * t[0]
        v00, v01, v10, v11 = taps
        return (v00 * u[0] * u[1] + v01 * t[0] * u[1]
                + v10 * u[0] * t[1] + v11 * t[0] * t[1])

    # -- the kernel form --------------------------------------------------
    def emit_src(self, em):
        tab = self.children[0]
        code = em.types[id(tab)]
        dims = self.img.shape[::-1]
        coords = []
        for c in self.children[1:]:
            cc = em.types[id(c)]
            coords.append((_var(em, em.cast(em.value(c), cc, _concrete(cc))),
                           _concrete(cc)))
        mask = em.at[1]
        if self.img.filter == "nearest":
            terms = [self._index_src(em, em.define(
                f"{self._round(em, v, c, 'rint')}.to(tl.int32)"), d, s)
                for (v, c), d, s in zip(coords, dims, _strides(dims))]
            return em.value(tab, (em.define(" + ".join(terms)), mask))
        rc = _concrete(em.types[id(self)])
        real = real_code(rc)
        i0, i1, t = [], [], []
        for (v, c), d, s in zip(coords, dims, _strides(dims)):
            nan = ", propagate_nan=tl.PropagateNan.ALL" \
                if dtype_of_code(c).is_floating_point else ""
            lo, hi = em.constant(0, c), em.constant(d - 1, c)
            v = em.define(f"tl.minimum(tl.maximum({v}, {lo}{nan}), "
                          f"{hi}{nan})")
            v0 = em.define(self._round(em, v, c, "floor"))
            w = em.cast(em.define(f"{v} - {v0}"), c, real_code(code))
            t.append(_var(em, em.cast(_var(em, w), real_code(code), real)))
            j = em.define(f"{v0}.to(tl.int32)")
            i0.append(self._index_src(em, j, d, s))
            i1.append(self._index_src(em, em.define(f"{j} + 1"), d, s))
        taps = [em.cast(em.value(tab, (em.define(" + ".join(ix)), mask)),
                        code, rc) for ix in self._corners(i0, i1)]
        one = em.constant(1, real)
        u = [em.define(f"{one} - {w}") for w in t]
        parts = 2 if rc in COMPLEX_CODES else 1
        out = []
        for k in range(parts):
            vs = [_var(em, v[k] if parts == 2 else v) for v in taps]
            if len(t) == 1:
                src = f"{vs[0]} * {u[0]} + {vs[1]} * {t[0]}"
            else:
                src = (f"{vs[0]} * {u[0]} * {u[1]} + {vs[1]} * {t[0]} * "
                       f"{u[1]} + {vs[2]} * {u[0]} * {t[1]} + {vs[3]} * "
                       f"{t[0]} * {t[1]}")
            out.append(em.define(src))
        return tuple(out) if parts == 2 else out[0]

    @staticmethod
    def _round(em, v: str, code: str, fn: str) -> str:
        """libdevice's rint or floor of a float coordinate (a 16-bit one
        through f32, which holds it exactly); an integer as it is."""
        dt = dtype_of_code(code)
        if not dt.is_floating_point:
            return v
        if code in ("f16", "bf16"):
            return (f"libdevice.{fn}({v}.to(tl.float32))"
                    f".to({'tl.float16' if code == 'f16' else 'tl.bfloat16'})")
        return f"libdevice.{fn}({v})"

    @staticmethod
    def _index_src(em, i: str, d: int, stride: int) -> str:
        """An i32 coordinate clamped into [0, d), in the kernel's index
        type, times its axis's stride in the flat table."""
        i = em.define(f"tl.minimum(tl.maximum({i}, 0), {d - 1})"
                      f".to({em.ity})")
        return i if stride == 1 else em.define(f"{i} * {stride}")


#: the signed type of the same width, for unsigned tables: PyTorch's CUDA
#: indexing takes no u16, u32 or u64
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The table's values at ``idx`` (in range)."""
    signed = _SIGNED.get(tab.dtype)
    if signed is None:
        return tab[idx]
    return tab.view(signed)[idx].view(tab.dtype)


def _strides(dims: Sequence[int]) -> List[int]:
    """The flat table's stride of each axis, x first."""
    out, s = [], 1
    for d in dims:
        out.append(s)
        s *= d
    return out


def _var(em, src):
    """``src`` as a variable (a pair of them as it is), defined only when
    it is an expression text."""
    return src if isinstance(src, tuple) or src.isidentifier() \
        else em.define(src)


class _Image:
    """The table on the context's device."""

    ndim = 0

    def __init__(self, data: Any, filter: str = "nearest", *,
                 context=None):
        """``data``: a numpy array (or a tensor, used on the context's
        device as it is)."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        if data.ndim != self.ndim:
            raise ValueError(f"{type(self).__name__} expects a "
                             f"{self.ndim}-D array")
        if filter not in _FILTERS:
            raise ValueError("filter must be 'nearest' or 'linear'")
        self.context = context or current_context()
        self.data = data.to(self.context.device).contiguous()
        self.shape = tuple(data.shape)
        self.filter = filter
        self._table = ArrayTerminal(self.data.reshape(-1))


class image2d(_Image):
    """A 2-D sampled image: ``img(x, y)`` inside expressions (x along the
    columns, y along the rows)."""

    ndim = 2

    def __call__(self, x: Any, y: Any) -> ImageSample:
        return ImageSample(self, x, y)


class image1d(_Image):
    """A 1-D sampled image: ``img(x)`` inside expressions."""

    ndim = 1

    def __call__(self, x: Any) -> ImageSample:
        return ImageSample(self, x)


class svm_vector(vector):
    """A vector with an explicit map/unmap host mirror
    (svm_vector.hpp:38-221)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._mapped: Optional[np.ndarray] = None

    def map(self, part: int = 0) -> np.ndarray:  # type: ignore[override]
        """A host copy of the vector, written back by ``unmap``."""
        self._mapped = np.array(self.to_numpy())
        return self._mapped

    def unmap(self) -> None:
        if self._mapped is not None:
            self.write_data(self._mapped)
            self._mapped = None

    def __enter__(self) -> np.ndarray:
        return self.map()

    def __exit__(self, *exc) -> None:
        self.unmap()
