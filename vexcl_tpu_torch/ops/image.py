"""Image terminals and mapped vectors.

Port of ``vexcl_tpu/ops/image.py`` (vexcl/image.hpp with
backend/cuda/texture_object.hpp, and vexcl/svm_vector.hpp).

* ``image1d``, ``image2d``: a read-only table sampled inside expressions,
  ``img(x)`` and ``img(x, y)``, nearest (``jnp.round``: half to even) or
  linear with clamp-to-edge addressing; a linear sample clamps its
  coordinates into the image first, as the JAX package does.  A sample
  is one node over the table and the coordinates, whose kernel form
  writes the clamps, the taps and the lerp into the assignment kernel
  (V1).  The reference binds a texture object; the port reads the table
  through the L1 and L2 caches.  On the H100 a scattered read costs its
  32-byte sector, not its 4 bytes (``csrc/gather.cu``), and a 4096^2 f32
  image (64 MB) is larger than the 50 MB L2, so a sample's time is set by
  the sectors it touches.
* A linear 2-D sample whose image ``patch_route`` takes reads the JAX
  package's bilinear patch table (``image2d._ensure_patch``,
  ``VEXTPU_IMG_PATCH_MB``, ``config.img_patch_mb``): row ``y*w + x``
  holds the edge-clamped texels (I[y, x], I[y, x+1], I[y+1, x],
  I[y+1, x+1]), 16 bytes of f32 (32 of f64) in one sector, read with one
  16-byte load a lane (two for f64) where the four taps touch two rows'
  sectors.  The table is built on the image's device by tensor copies at
  the first such sample (construction, like a sparse format's), and
  again where the image's tensor was written in place since
  (``Tensor._version``); the lerp is the four-tap form's, term by term.
  An image over the budget, or of another type, keeps the four taps.
* A nearest 2-D sample alone in an assignment, of two leaf float
  coordinate arrays of one type, goes through the gather form's fused
  variant (``csrc/gather.cu``, ``cuda_gather.gather_coords``) where
  ``cuda_gather.index_route`` takes it (``expr/triton_emit.py``,
  ``_index_gather_operands``): its partition kernel computes the clamped
  flat index ``flat_coords`` describes, and the table is read by ranges.
* ``svm_vector``: a vector with the reference's map/unmap protocol over a
  host mirror: ``map()`` copies the vector to the host, ``unmap()`` writes
  the mirror back, and ``with v as host:`` does both.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..context import current_context
from ..expr.node import ArrayTerminal, EmitEnv, as_expr, convert
from ..expr.view import _View
from ..types import COMPLEX_CODES, dtype_of_code, real_code
from ..vector import vector

__all__ = ["image1d", "image2d", "svm_vector", "patch_route",
           "patch_table"]

_FILTERS = ("nearest", "linear")
#: the assignment kernel's (BLOCK, warps) over a linear sample: one
#: element a thread.  2^24 bilinear samples of a 4096^2 f32 image took
#: 0.765 ms at this shape on an H100 SXM (700 W), 0.962 at the default
#: (1024, 4); nearest ones gain 1% (``scripts/torch_image_shapes.py``)
_LINEAR_SHAPE = (256, 8)

#: the types the patch form takes: rows of 16 or 32 bytes, one sector
PATCH_TAKES = (torch.float32, torch.float64, torch.int32, torch.int64)
# The patch table's route, from scripts/torch_image_turns.py --sweep (f32,
# f64 and i32 images of 2^14 to 2^28 bytes, 1/16 to 16 points a texel,
# uniform and clustered points, events ms of the four taps and the table
# forced, on an H100 80GB HBM3 at 700 W; PERF.md §6): from images of 64
# MB, which overflow the 50 MB L2, the table took 0.54-0.81x the taps'
# time for uniform points of every density (1.01 at 1/16 a texel of 64
# MB of f32).  Below, the taps hit L2 where the 4x table does not
# (1.12-1.36x at 16-32 MB), or the call's host time sets both.  Clustered
# points lose 1.03-1.68x with the table (the taps then hit L1 and L2); the
# route sees sizes and types only.
#: the types whose linear 2-D samples read the patch table
PATCH_TYPES = (torch.float32, torch.float64, torch.int32)
#: the least image bytes for which the table is built
PATCH_MIN_BYTES = 1 << 26

#: the form of a linear 2-D sample made from now on, forced: "patch" or
#: "taps" ("patch" on a type the table does not take raises); None
#: leaves it to ``patch_route`` (the card's samples; a CPU image keeps
#: the four taps)
FORCE: Optional[str] = None


def patch_route(dtype: torch.dtype, h: int, w: int, budget_mb: int) -> bool:
    """True where a linear sample of an (h, w) image of ``dtype`` reads
    the patch table: a type of ``PATCH_TYPES``, at least
    ``PATCH_MIN_BYTES`` of image, at most ``budget_mb`` MiB of table, and
    fewer than 2^31 table elements."""
    table = 4 * h * w
    return (dtype in PATCH_TYPES and h * w * dtype.itemsize
            >= PATCH_MIN_BYTES and table * dtype.itemsize <= budget_mb << 20
            and table < 1 << 31)


def patch_table(data: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's bilinear patch table of the 2-D ``data``
    (``vexcl_tpu/ops/image.py``, ``image2d._ensure_patch``), flat on its
    device: (h*w*4,), row ``y*w + x`` holding (I[y, x], I[y, x+1],
    I[y+1, x], I[y+1, x+1]) with x+1 and y+1 clamped to the last column
    and row; written into ``out`` where given.  The image is copied with
    its last column and row repeated (P, (h+1, w+1)), and the table is one
    copy of P's overlapping (h, w, 2, 2) view, written in order: it reads
    the image about twice and writes the table once."""
    h, w = data.shape
    if out is None:
        out = torch.empty(h * w * 4, dtype=data.dtype, device=data.device)
    pad = torch.empty(h + 1, w + 1, dtype=data.dtype, device=data.device)
    pad[:h, :w] = data
    pad[:h, w] = data[:, -1]
    pad[h] = pad[h - 1]
    out.view(h, w, 2, 2).copy_(
        pad.as_strided((h, w, 2, 2), (w + 1, 1, w + 1, 1)))
    return out


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
        #: the table child is the patch table (a linear 2-D sample)
        self.patched = img._patch_form()
        tab = img._patch_leaf() if self.patched else img._table
        self.children = (tab,) + tuple(as_expr(c) for c in coords)
        if img.filter == "linear":
            self.kernel_shape = _LINEAR_SHAPE

    def extra_sig(self) -> str:
        p = ":p" if self.patched else ""
        return f"{self.img.filter}:{self.img.shape}{p}"

    def _infer(self, child_codes):
        if self.img.filter == "linear" and child_codes[0] == "b1":
            return "i*"
        return child_codes[0]

    def child_sizes(self, m):
        return [int(self.img.data.numel()) * (4 if self.patched else 1)] \
            + [m] * (len(self.children) - 1)

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
            return _take(tab, self._flat(self._nearest(coords), dims))
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
        if self.patched:
            # the patch table's row at the first corner holds the four
            taps = list(_take(tab.view(-1, 4), self._flat(i0, dims)).t())
        else:
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

    def flat_coords(self):
        """A nearest 2-D sample's x and y (see ``_View.flat_coords``)."""
        if self.img.filter != "nearest" or self.img.ndim != 2:
            return None
        h, w = self.img.shape
        return (self.children[1], self.children[2], (w, h), (1, w), 0,
                True)

    @staticmethod
    def _nearest(coords: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each coordinate rounded half to even and converted to i32 as
        ``astype`` converts it (a float saturating, NaN 0)."""
        return [convert(torch.round(c), "i32") if c.is_floating_point()
                else c.to(torch.int32) for c in coords]

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
        coords = self._coords_src(em)
        mask = em.at[1]
        if self.img.filter == "nearest":
            return em.value(tab, (self._nearest_src(em, coords), mask))
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
            if not self.patched:
                i1.append(self._index_src(em, em.define(f"{j} + 1"), d, s))
        if self.patched:
            taps = em.load_quad(tab, em.define(" + ".join(i0)), mask)
        else:
            taps = [em.value(tab, (em.define(" + ".join(ix)), mask))
                    for ix in self._corners(i0, i1)]
        taps = [em.cast(v, code, rc) for v in taps]
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

    def _coords_src(self, em):
        """The coordinates' variables, each in its compute code."""
        out = []
        for c in self.children[1:]:
            cc = em.types[id(c)]
            out.append((_var(em, em.cast(em.value(c), cc, _concrete(cc))),
                        _concrete(cc)))
        return out

    def _nearest_src(self, em, coords) -> str:
        """``_nearest`` and ``_flat`` in the kernel: the flat index."""
        dims = self.img.shape[::-1]
        terms = [self._index_src(em, em.define(em.cast(
            self._round(em, v, c, "rint"), c, "i32")), d, s)
            for (v, c), d, s in zip(coords, dims, _strides(dims))]
        return em.define(" + ".join(terms))

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
        self._patch: Optional[torch.Tensor] = None
        self._patch_version = -1
        self._patch_terminal: Optional[_PatchTerminal] = None

    def _patch_form(self) -> bool:
        """Whether a sample made now reads the patch table (``FORCE``,
        else ``patch_route`` on a CUDA image)."""
        if self.filter != "linear" or self.ndim != 2 or FORCE == "taps":
            return False
        if FORCE == "patch":
            if self.data.dtype not in PATCH_TAKES:
                raise NotImplementedError(
                    f"no patch table for {self.data.dtype} images")
            return True
        return self.data.device.type == "cuda" and patch_route(
            self.data.dtype, *self.shape, config.img_patch_mb)

    def patch(self) -> torch.Tensor:
        """The patch table (``patch_table``), built at the first call and
        rebuilt in place where the image's tensor was written in place
        since (its ``_version`` moved)."""
        version = self.data._version
        if self._patch is None:
            self._patch = patch_table(self.data)
            # a generator kernel's record keeps the table as a leaf and
            # calls this before each launch (``generator.Kernel._leaves``)
            self._patch.vex_refresh = self.patch
        elif version != self._patch_version:
            patch_table(self.data, self._patch)
        self._patch_version = version
        return self._patch

    def _patch_leaf(self) -> "_PatchTerminal":
        if self._patch_terminal is None:
            self._patch_terminal = _PatchTerminal(self)
        self.patch()
        return self._patch_terminal


class _PatchTerminal(ArrayTerminal):
    """An image's patch table as a leaf: every analysis reads it through
    ``_Image.patch``, which rebuilds a stale one."""

    def __init__(self, img: _Image):
        self.img = img

    @property
    def array(self) -> torch.Tensor:
        return self.img.patch()


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
