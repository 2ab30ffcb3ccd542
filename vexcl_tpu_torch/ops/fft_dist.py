"""The FFT over the parts of a partitioned vector: the four-step transform.

Port of ``vexcl_tpu/ops/fft_dist.py:47-166``.  Where the parts of the
vector are equal, a 1-D transform of n = n1 n2 points with D | n1 and D |
n2 (``split_1d``), and a full 2-D transform of an (r, c) array with D | r
and D | c (``splittable_2d``), run part by part without gathering the
signal, each part on its own device:

    X[k1 + n1 k2] = sum_j2 W_n^(j2 k1) W_n2^(j2 k2) sum_j1 x[j1 n2 + j2] W_n1^(j1 k1)

* a local transform is the port's own engine on the part: cuFFT into its
  target (``ops/cufft.py``) on the card, ``Plan``'s plain path on the CPU,
  batched over the part's rows (``Plan((rows, length), dims=(1,))``);
* a transpose of a part is V1's tiled transpose (``expr/triton_emit.py``
  ``assign_tiled_source``: the generated assignment kernel of a
  ``reshape`` of order (1, 0), (32, 32) tiles through shared memory);
* the all-to-all is D^2 tile copies between parts: part d's rows [e rb,
  (e + 1) rb) go to columns [d cs, (d + 1) cs) of part e, each part's D
  tiles one ``torch.cat`` into it (``_all_to_all``; a tile on another card
  moves first, by PyTorch's peer copy, ordered by events on both devices'
  streams, so nothing waits for the host);
* the 1-D twiddle W_n^(j2 k1) is computed inside the second transpose's
  generated kernel from the element index, as the JAX package builds it
  from iota (``_twiddle_chunk``): the product j2 k1 < n exact in i64, the
  angle in the plan's real type (f64 for c128; f32 for c64, where j2 k1
  converts exactly below 2^24, as :76-78 notes).

1-D: all-to-all, transpose, transform the n1 axis, the twiddle fused
into the transpose back, all-to-all, transform the n2 axis, transpose,
and the last all-to-all writes the natural order into the target's parts.
2-D: transform the rows, transpose, all-to-all, transform the columns,
transpose, and the last all-to-all writes the target.  An inverse is
scaled by the local plans, 1/n1 and 1/n2 (1/r and 1/c).  The transposes
read and write only two workspace buffers a part, which the plan keeps
for each set of devices and streams with the transposes' expressions
analysed once (``_FourStep``): a call costs its launches and copies, not
the analysis of its trees.

Where the geometry does not decompose (parts of unequal size, n not
divisible by D^2, a 2-D array whose extents D does not divide, other
``dims``), the JAX package transforms the sharded array through XLA,
which gathers it.  The port does the same openly (``gathered``): the
parts are copied to the first part's device, transformed there by the
one-part plan, and the result is copied back into the parts.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["split_1d", "splittable_2d", "decomposes", "four_step",
           "gathered", "transform_parts"]


def _smooth(n: int) -> bool:
    from .fft import MAX_CODELET, prime_factors

    return max(prime_factors(n), default=1) <= MAX_CODELET


@lru_cache(maxsize=None)
def split_1d(n: int, d: int) -> Optional[Tuple[int, int]]:
    """The balanced n = n1 n2 with d | n1, d | n2 and both factors smooth
    (every prime within the codelets), or None (the JAX package's rule,
    ``vexcl_tpu/ops/fft_dist.py:47-67``)."""
    if d < 2 or n % (d * d) != 0:
        return None
    m = n // (d * d)
    best = None
    a = 1
    while a * a <= m:
        if m % a == 0:
            for aa in (a, m // a):
                n1 = d * aa
                n2 = n // n1
                if _smooth(n1) and _smooth(n2):
                    score = abs(n1 - n2)
                    if best is None or score < best[0]:
                        best = (score, n1, n2)
        a += 1
    return (best[1], best[2]) if best else None


def splittable_2d(r: int, c: int, d: int) -> bool:
    """A full 2-D transform decomposes when d divides both extents and
    both are smooth (``vexcl_tpu/ops/fft_dist.py:132-139``)."""
    return d > 1 and r % d == 0 and c % d == 0 and _smooth(r) and _smooth(c)


def decomposes(plan, pts: np.ndarray) -> bool:
    """Whether ``plan`` runs as the four-step transform over parts split at
    ``pts``: a 1-D transform with a split, or a full 2-D one that is
    splittable (the JAX package's routing, ``vexcl_tpu/ops/fft.py:
    538-572``), over equal parts."""
    d = len(pts) - 1
    sizes = np.diff(pts)
    if d < 2 or int(pts[-1]) != plan.size or (sizes != sizes[0]).any():
        return False
    if len(plan.shape) == 1 and len(plan.dims) == 1:
        return split_1d(plan.shape[0], d) is not None
    if len(plan.shape) == 2 and tuple(sorted(plan.dims)) == (0, 1):
        return splittable_2d(plan.shape[0], plan.shape[1], d)
    return False


def _local(shape: Tuple[int, int], inverse: bool, dtype: torch.dtype):
    """The one-part plan that transforms the last axis of ``shape``."""
    from .fft import Plan, plan_cache

    key = (shape, (1,), inverse, str(dtype), "xla")
    return plan_cache.get_or_create(
        key, lambda: Plan(shape, (1,), inverse, dtype))


def _twiddle(n: int, rows: int, offset: int, sign: float,
             dtype: torch.dtype):
    """W_n^(j2 k1) at element i of a (n1, rows) array: k1 = i // rows and
    j2 = offset + i % rows (the part's rows of j2 start at ``offset``), as
    an expression of the element index."""
    from ..expr.builtins import BUILTINS
    from ..expr.node import CastExpr, ElementIndex

    real = torch.float64 if dtype == torch.complex128 else torch.float32
    i = ElementIndex()
    prod = (i % rows + offset) * (i // rows)
    ang = CastExpr(real, prod) * (2.0 * math.pi / n)
    return BUILTINS["cos"](ang) + BUILTINS["sin"](ang) * complex(0.0, sign)


class _Transpose:
    """``out`` (cols, rows) = ``src`` (rows, cols) transposed, both flat,
    times ``twiddle`` where one is given: V1's tiled kernel, its
    expression prepared and its kernel key computed once (the tensors are
    a workspace's)."""

    def __init__(self, src: torch.Tensor, rows: int, cols: int,
                 out: torch.Tensor, twiddle=None):
        from ..expr.compile import prepare
        from ..expr.node import ArrayTerminal
        from ..expr.triton_emit import launch_key
        from ..expr.view import reshape

        value = reshape(ArrayTerminal(src), (cols, rows), (1, 0))
        if twiddle is not None:
            value = value * twiddle
        expr, analysis, types, leaves = prepare(value, rows * cols,
                                                out.device)
        self.args = ([expr], analysis, types, leaves, [out])
        self.keyed = launch_key([expr], analysis, [out.dtype])

    def __call__(self) -> None:
        from ..expr.triton_emit import assign_multi

        assign_multi(*self.args, self.keyed)


def _all_to_all(src: Sequence[torch.Tensor], dst: Sequence[torch.Tensor],
                rb: int, cs: int, to_rows: bool = False) -> None:
    """D^2 tiles: part d's (D rb, cs) rows [e rb, (e + 1) rb) into
    columns [d cs, (d + 1) cs) of part e's (rb, D cs); with ``to_rows``
    the other way, part d's (rb, D cs) columns [e cs, (e + 1) cs) into
    rows [d rb, (d + 1) rb) of part e's (D rb, cs).  Each part's D tiles
    are one ``torch.cat`` into it, a tile on another device moved there
    first."""
    nparts = len(src)
    for e, out in enumerate(dst):
        if to_rows:
            tiles = [x.view(rb, nparts * cs)[:, e * cs:(e + 1) * cs]
                     for x in src]
            o, dim = out.view(nparts * rb, cs), 0
        else:
            tiles = [x.view(nparts * rb, cs)[e * rb:(e + 1) * rb]
                     for x in src]
            o, dim = out.view(rb, nparts * cs), 1
        torch.cat([t.to(out.device, non_blocking=True) for t in tiles], dim,
                  out=o)


class _FourStep:
    """The four-step transform of ``plan`` over parts on ``devices``: two
    workspace buffers a part, the local plans and the prepared
    transposes, kept by the plan a (devices, streams) (``four_step``).

    1-D, n = n1 n2, l1 = n1 / D, l2 = n2 / D: the all-to-all takes part
    d's (l1, n2) block to (n1, l2) blocks, a transpose to (l2, n1), the n1
    transform, the transpose back with the twiddle, the all-to-all to
    (l1, n2), the n2 transform, a transpose to (n2, l1), and the last
    all-to-all writes the natural order, (l2, n1) a part.  2-D (r, c),
    lr = r / D, lc = c / D: the rows' transform, a transpose to (c, lr),
    the all-to-all to (lc, r), the columns' transform, a transpose to
    (r, lc), and the last all-to-all writes (lr, c) a part."""

    def __init__(self, plan, devices: Sequence[torch.device], m: int):
        nparts = len(devices)
        dt = plan.dtype
        self.a = [torch.empty(m, dtype=dt, device=d) for d in devices]
        self.b = [torch.empty(m, dtype=dt, device=d) for d in devices]
        a, b = self.a, self.b
        if len(plan.shape) == 1:
            n = plan.shape[0]
            n1, n2 = split_1d(n, nparts)
            self.l1, self.l2 = l1, l2 = n1 // nparts, n2 // nparts
            self.p1 = _local((l2, n1), plan.inverse, dt)
            self.p2 = _local((l1, n2), plan.inverse, dt)
            self.t1 = [_Transpose(a[e], n1, l2, b[e]) for e in range(nparts)]
            self.t2 = [_Transpose(a[e], l2, n1, b[e], _twiddle(
                n, l2, e * l2, plan.sign, dt)) for e in range(nparts)]
            self.t3 = [_Transpose(b[e], l1, n2, a[e]) for e in range(nparts)]
            return
        r, c = plan.shape
        self.lr, self.lc = lr, lc = r // nparts, c // nparts
        self.p1 = _local((lr, c), plan.inverse, dt)
        self.p2 = _local((lc, r), plan.inverse, dt)
        self.t1 = [_Transpose(a[e], lr, c, b[e]) for e in range(nparts)]
        self.t2 = [_Transpose(b[e], lc, r, a[e]) for e in range(nparts)]
        self.t3 = None

    def __call__(self, xs: Sequence[torch.Tensor],
                 outs: Sequence[torch.Tensor]) -> None:
        a, b = self.a, self.b
        if self.t3 is not None:                   # 1-D
            l1, l2 = self.l1, self.l2
            _all_to_all(xs, a, l1, l2, to_rows=True)   # (n1, l2)
            for e, t in enumerate(a):
                self.t1[e]()                      # (l2, n1): local j2, j1
                self.p1(b[e], t)                  # over j1 -> k1
                self.t2[e]()                      # (n1, l2), twiddled
            _all_to_all(b, a, l1, l2)             # (l1, n2): local k1, j2
            for e, t in enumerate(a):
                self.p2(t, b[e])                  # over j2 -> k2
                self.t3[e]()                      # (n2, l1): k2, local k1
            _all_to_all(a, outs, l2, l1)          # (l2, n1): local k2, k1
            return
        lr, lc = self.lr, self.lc
        for e, x in enumerate(xs):
            self.p1(x, a[e])                      # the rows
            self.t1[e]()                          # (c, lr)
        _all_to_all(b, a, lc, lr)                 # (lc, r): local kc, i
        for e, t in enumerate(a):
            self.p2(t, b[e])                      # the columns
            self.t2[e]()                          # (r, lc)
        _all_to_all(a, outs, lr, lc)              # (lr, c)


def four_step(plan, xs: Sequence[torch.Tensor],
              outs: Sequence[torch.Tensor]) -> None:
    """``plan``'s transform of the equal parts ``xs`` (flat, of the plan's
    type) into the parts ``outs`` (``outs`` may be ``xs``), with the
    plan's workspace for these devices and their current streams."""
    devices = tuple(x.device for x in xs)
    key = devices + tuple(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else None for d in devices)
    steps = plan.parts.get(key)
    if steps is None:
        steps = plan.parts[key] = _FourStep(plan, devices, xs[0].numel())
    steps(xs, outs)


def gathered(plan, xs: Sequence[torch.Tensor], pts: np.ndarray,
             outs: Sequence[torch.Tensor]) -> None:
    """``plan``'s transform of the parts ``xs`` gathered to the first
    part's device and written back into ``outs`` (the route of a geometry
    that does not decompose)."""
    from ..parallel.halo import all_gather

    whole = all_gather(xs, [xs[0].device])[0]
    res = plan(whole, torch.empty_like(whole))
    for o, lo, hi in zip(outs, pts[:-1], pts[1:]):
        o.copy_(res[int(lo):int(hi)], non_blocking=True)


def transform_parts(plan, xs: List[torch.Tensor], pts: np.ndarray,
                    outs: List[torch.Tensor]) -> None:
    """``plan``'s transform of the parts ``xs`` into ``outs``: the
    four-step transform for a ``"dist"`` plan, else the gathered route."""
    if plan.impl == "dist":
        if not decomposes(plan, pts):
            raise ValueError(
                f"impl='dist': shape {plan.shape} over dims {plan.dims} "
                f"does not decompose over {len(pts) - 1} parts of sizes "
                f"{np.diff(pts).tolist()}")
        four_step(plan, xs, outs)
    else:
        gathered(plan, xs, pts, outs)
