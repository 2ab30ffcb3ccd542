"""FFT: ``FFT``/``fft``/``ifft`` expression terminals over cuFFT, and the
JAX package's own mixed-radix Cooley-Tukey engine.

Port of ``vexcl_tpu/ops/fft.py`` (vexcl/fft/*: the FFT terminal fft.hpp:40-,
the planner plan.hpp:112-145, prime_factors :81, Bluestein :344-520)::

    f = vex.FFT(n)                      # 1-D complex, forward
    y[:] = f(x)                         # an expression terminal
    fi = vex.FFT(n, inverse=True)       # scaled by 1/n like the reference
    f2 = vex.FFT((rows, cols))          # 2-D
    fb = vex.FFT((batch, n), dims=(1,)) # batched 1-D (fft::none)

An ``FFTExpr`` is not elementwise: the assignment runs it first, into a
complex temporary (``compile.hoist``), and the rest of the tree reads that
in one generated kernel (``p[:] = fx * conj(fx)``: complex pairs,
``expr/triton_emit.py``); a tree that is only the transform, assigned to
a complex target of its length that it does not read, writes straight
into the target (``y[:] = f(x)`` of a vector x goes from
``vector.assign`` to the plan with no expression analysis,
``FFTExpr.into_vector``).  Its input is evaluated and cast to the plan's
type first (a real input becomes complex, as in the JAX package; no
``rfft``).

Two engines (``impl``):

* ``"xla"``, the default: the JAX package calls XLA's FFT HLO there,
  which is no Pallas kernel; here it is cuFFT on the card, run by
  ``ops/cufft.py`` straight into the target where one plan covers
  ``dims`` (``torch.fft.fftn(out=)`` would write a temporary and copy
  it), else ``torch.fft.fftn``/``ifftn`` over ``dims`` (the inverse
  scaled by 1/n as ``jnp.fft.ifftn`` does).  As a plain product may stay
  ``torch.matmul``,
  the library transform that stands where XLA's stood is no hand-written
  kernel, and none is claimed.  cuFFT handles large primes itself, so the
  JAX package's routing of large-prime lengths away from the TPU's FFT
  lowering (``_route_ct``) and its TPU-measured auto-route window
  (``_auto_ct``) are not carried over.
* ``"ct"``: the JAX package's own planner, ported as plain PyTorch on
  planar (re, im) tensors: a balanced mixed-radix plan of DFT-matrix
  codelets (radix at most ``MAX_CODELET``) applied as matrix products
  (``torch.matmul``, as the JAX package leaves its codelets to XLA dots
  outside any Pallas kernel), twiddles between stages, and Bluestein's
  chirp-z for a prime factor above the cap.  f32 products run at full f32
  precision: where ``torch.backends.cuda.matmul.allow_tf32`` is set, it
  is cleared around the engine's products and restored.  Its TPU tuning
  (the ``VEXTPU_FFT_RADIX``/``_FORM``/``_X3`` knobs, ``_dot_alg``'s bf16
  presets and the flat-cube form) is not ported.
* ``"dist"``: the JAX package's four-step transform over the parts of a
  partitioned vector (``ops/fft_dist.py``), 1-D and full 2-D.  ``FFT``
  swaps it in for an ``"xla"`` or ``"ct"`` plan where its input is a
  partitioned vector whose equal parts the geometry decomposes over
  (``fft_dist.decomposes``); over other parts the transform is gathered
  to the first part's device and written back (``fft_dist.gathered``).
  Over parts the transform writes into a partitioned target of its type
  part by part (``FFTExpr.parts_into``), or into a partitioned temporary
  inside a larger tree (``FFTExpr.materialize_parts``).

The default type is c64, as the port's default float is f32.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..cache import ObjectCache
from ..expr.node import EmitEnv, Expr, VectorTerminal, as_expr
from ..types import dtype_of
from . import cufft

__all__ = ["FFT", "fft", "ifft", "prime_factors", "plan_cache", "Plan",
           "FFTExpr", "MAX_CODELET"]

#: the largest direct-DFT codelet of the ``"ct"`` engine, as the JAX
#: package's default
MAX_CODELET = 256

plan_cache = ObjectCache("fft_plans")


def prime_factors(n: int) -> Tuple[int, ...]:
    """fft/plan.hpp prime_factors :81."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@lru_cache(maxsize=None)
def _radix_plan(n: int, maxc: int) -> Tuple[int, ...]:
    """Balanced stage plan: pack n's prime factors into the fewest groups
    each <= maxc, sizes as equal as the factorization allows (planner
    policy of fft/plan.hpp:112-145)."""
    primes = sorted(prime_factors(n), reverse=True)
    if primes and primes[0] > maxc:
        raise ValueError(f"{n} has a prime factor > {maxc}")
    k = 1
    while True:
        groups = [1] * k
        for p in primes:
            groups.sort()
            if groups[0] * p <= maxc:
                groups[0] *= p
            else:
                break
        else:
            return tuple(sorted(groups, reverse=True))
        k += 1


@lru_cache(maxsize=None)
def _codelet_planar_np(n: int, sign: float, real_dtype: str):
    """DFT_n as (re, im) f32/f64 planes (planar split-complex)."""
    k = np.arange(n)
    w = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return (w.real.astype(real_dtype).copy(),
            w.imag.astype(real_dtype).copy())


@lru_cache(maxsize=None)
def _codelets(n: int, sign: float, dtype: torch.dtype, device: torch.device,
              last: bool):
    """The one-pass stacked codelets of DFT_n on ``device``: for the radix
    axis (``last`` False) [wr; wi] and [-wi; wr], (2n, n); for the last
    axis [wr | wi] and [-wi | wr], (n, 2n)."""
    cr, ci = _codelet_planar_np(n, sign, str(dtype).replace("torch.", ""))
    cr = torch.from_numpy(cr).to(device)
    ci = torch.from_numpy(ci).to(device)
    axis = 1 if last else 0
    return (torch.cat([cr, ci], dim=axis).contiguous(),
            torch.cat([-ci, cr], dim=axis).contiguous())


@contextlib.contextmanager
def _full_f32(t: torch.Tensor):
    """f32 products on the card at full precision: TF32, where it is
    allowed, is turned off for the block and restored after it."""
    m = torch.backends.cuda.matmul
    if not (t.is_cuda and t.dtype == torch.float32 and m.allow_tf32):
        yield
        return
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = True


_OCT_C = np.cos(np.arange(8) * np.pi / 4)
_OCT_S = np.sin(np.arange(8) * np.pi / 4)


def _sincos_2pi(frac: torch.Tensor):
    """(cos, sin) of 2*pi*frac for frac in [0, 1), octant-reduced in f32:
    a plain f32 ``cos(2*pi*frac)`` quantizes the angle at ~1e-7*|angle|;
    reduced to |angle| <= pi/4 the quantization shrinks ~8x, and the
    octant rotation constants are exact or 1 ulp."""
    if frac.dtype == torch.float64:
        ang = 2.0 * np.pi * frac
        return torch.cos(ang), torch.sin(ang)
    o = torch.floor(frac * 8.0)
    a = (2.0 * np.pi) * (frac - o * 0.125)
    ca, sa = torch.cos(a), torch.sin(a)
    oi = o.to(torch.int64)
    ch = torch.tensor(_OCT_C, dtype=frac.dtype, device=frac.device)[oi]
    sh = torch.tensor(_OCT_S, dtype=frac.dtype, device=frac.device)[oi]
    return ch * ca - sh * sa, sh * ca + ch * sa


def _twiddle_planar(r: int, m: int, sign: float, dtype: torch.dtype,
                    device: torch.device):
    """Twiddle planes W_{rm}^{k1*j2}, (r, m), exact for r*m <= 2^24: the
    integer product k1*j2 < r*m in i64, its float conversion exact below
    2^24."""
    k1 = torch.arange(r, device=device).reshape(r, 1)
    j2 = torch.arange(m, device=device).reshape(1, m)
    frac = (k1 * j2).to(dtype) * (1.0 / (r * m))
    c, s = _sincos_2pi(frac)
    return c, s if sign > 0 else -s


def _cmatmul_radix(w, xr, xi):
    """Complex codelet over the radix axis: W @ X with W constant (r, r)
    and X = (..., r, m) planar, in one pass: [Yr; Yi] = [wr; wi] @ Xr +
    [-wi; wr] @ Xi."""
    wa, wb = w
    r = wa.shape[1]
    with _full_f32(xr):
        y2 = torch.matmul(wa, xr) + torch.matmul(wb, xi)
    return y2[..., :r, :], y2[..., r:, :]


def _cmatmul_last(xr, xi, w):
    """Base-case codelet: X @ W over the last axis (n <= codelet), in one
    pass: [Yr | Yi] = Xr @ [wr | wi] + Xi @ [-wi | wr]."""
    wa, wb = w
    k = wa.shape[0]
    with _full_f32(xr):
        y2 = torch.matmul(xr, wa) + torch.matmul(xi, wb)
    return y2[..., :k], y2[..., k:]


def _fft_planar(xr: torch.Tensor, xi: torch.Tensor, sign: float,
                plan: Tuple[int, ...]):
    """Mixed-radix planar Cooley-Tukey over the last axis following the
    balanced stage plan."""
    n = xr.shape[-1]
    if n == 1:
        return xr, xi
    dt, dev = xr.dtype, xr.device
    if len(plan) == 1:
        return _cmatmul_last(xr, xi, _codelets(n, sign, dt, dev, True))
    r = plan[0]
    m = n // r
    batch = tuple(xr.shape[:-1])
    ar, ai = _cmatmul_radix(_codelets(r, sign, dt, dev, False),
                            xr.reshape(batch + (r, m)),
                            xi.reshape(batch + (r, m)))
    tr, ti = _twiddle_planar(r, m, sign, dt, dev)
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    br, bi = _fft_planar(br, bi, sign, plan[1:])  # batched over the r rows
    # output index r*k2 + k1: swap (k1, k2) before the ravel
    return (br.transpose(-1, -2).reshape(batch + (n,)),
            bi.transpose(-1, -2).reshape(batch + (n,)))


def _fft_1d(x: torch.Tensor, sign: float) -> torch.Tensor:
    """The transform along the last axis, batched over the leading ones."""
    n = x.shape[-1]
    if n == 1:
        return x
    if max(prime_factors(n)) > MAX_CODELET:
        # a prime factor beyond the codelets: chirp-z the whole transform
        return _bluestein(x, sign)
    yr, yi = _fft_planar(x.real.contiguous(), x.imag.contiguous(), sign,
                         _radix_plan(n, MAX_CODELET))
    return torch.complex(yr, yi)


@lru_cache(maxsize=None)
def _chirp(n: int, sign: float, dtype: torch.dtype, device: torch.device):
    """Bluestein's chirp of n and the transform of its padded conjugate."""
    m = _next_pow2(2 * n - 1)
    nd = str(dtype).replace("torch.", "")
    k = np.arange(n)
    chirp = np.exp(sign * 1j * np.pi * (k * k % (2 * n)) / n).astype(nd)
    b = np.zeros(m, dtype=nd)
    b[:n] = np.conj(chirp)
    b[m - n + 1:] = np.conj(chirp[1:][::-1])
    bf = np.fft.fft(b).astype(nd)
    return (torch.from_numpy(chirp).to(device),
            torch.from_numpy(bf).to(device), m)


def _bluestein(x: torch.Tensor, sign: float) -> torch.Tensor:
    """Chirp-z for any n (fft/kernels.hpp bluestein_* :344-520)."""
    n = x.shape[-1]
    chirp, bf, m = _chirp(n, sign, x.dtype, x.device)
    a = torch.nn.functional.pad(x * chirp, (0, m - n))
    af = _fft_1d(a, -1.0)
    c = _fft_1d(af * bf, +1.0) / m
    return c[..., :n] * chirp


class Plan:
    """An FFT plan over an N-D logical shape (fft/plan.hpp planner): the
    transformed axes ``dims`` (all by default; the others are batch axes),
    the direction, the complex type and the engine (module docstring)."""

    def __init__(self, shape: Tuple[int, ...], dims: Optional[Sequence[int]],
                 inverse: bool, dtype, impl: str = "xla"):
        if impl not in ("xla", "ct", "dist"):
            raise ValueError(f"unknown FFT engine {impl!r}")
        self.shape = tuple(int(s) for s in shape)
        self.dims = (tuple(int(d) for d in dims) if dims is not None
                     else tuple(range(len(self.shape))))
        if impl == "dist" and not (
                len(self.shape) == len(self.dims) and len(self.shape) <= 2):
            raise ValueError("impl='dist' supports 1-D and full 2-D")
        self.inverse = inverse
        self.dtype = dtype_of(dtype)
        if not self.dtype.is_complex:
            raise TypeError(f"an FFT plan is complex, not {self.dtype}")
        self.impl = impl
        self.sign = +1.0 if inverse else -1.0
        self.size = int(np.prod(self.shape, dtype=np.int64))
        #: one cuFFT plan's layout over ``dims``, or None (``cufft``)
        self.cufft_layout = cufft.layout(self.shape, self.dims)
        #: (device index, stream) -> its cuFFT plan
        self.cufft: dict = {}
        #: a "dist" plan's (part devices, their streams) -> its four-step
        #: workspace (``fft_dist.four_step``)
        self.parts: dict = {}

    def __call__(self, x: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The transform of ``x`` (the shape, or its flat length), cast to
        the plan's type first; into ``out`` where it is given."""
        if self.impl == "dist":
            raise ValueError("impl='dist' transforms the parts of a vector "
                             "of a context of several parts")
        if (self.impl == "xla" and out is not None and x.is_cuda
                and self.cufft_layout is not None and x.dtype == self.dtype
                and out.dtype == self.dtype and out.device == x.device
                and x.is_contiguous() and out.is_contiguous()
                and x.numel() == out.numel() == self.size):
            # cuFFT straight into out: torch.fft's out= would copy
            cufft.execute(self, x, out)
            return out
        flat_in = x.ndim == 1 and len(self.shape) > 1
        if flat_in:
            x = x.reshape(self.shape)
        x = x.to(self.dtype)
        if self.impl == "xla":
            fn = torch.fft.ifftn if self.inverse else torch.fft.fftn
            if out is None:
                y = fn(x, dim=self.dims)
                return y.reshape(-1) if flat_in else y
            fn(x, dim=self.dims, out=out.view(x.shape))
            return out
        for d in self.dims:
            x = _fft_1d(x.movedim(d, -1), self.sign).movedim(-1, d)
        if self.inverse:
            x = x * (1.0 / np.prod([self.shape[d] for d in self.dims]))
        if out is None:
            return x.reshape(-1) if flat_in else x
        out.view(x.shape).copy_(x)
        return out


class FFTExpr(Expr):
    """The transform of an expression: not elementwise (``materialize``
    runs it first into a temporary, ``compile.hoist``)."""

    _opname = "fft"
    _elementwise = False

    def __init__(self, plan: Plan, x: Any):
        self.plan = plan
        self.children = (as_expr(x),)

    def extra_sig(self) -> str:
        # the engine is part of the structure: an xla and a ct plan of one
        # geometry must not share a cached kernel
        p = self.plan
        return f"{p.shape}:{p.dims}:{p.inverse}:{p.dtype}:{p.impl}"

    def _infer(self, child_codes):
        from ..types import code_of

        return code_of(self.plan.dtype)

    def child_sizes(self, m):
        return [self.plan.size]

    def size_hint(self) -> Optional[int]:
        return self.plan.size

    def direct_dtype(self) -> torch.dtype:
        """The transform's type: ``materialize`` writes it straight into a
        target of that type (``compile.evaluate``'s direct path)."""
        return self.plan.dtype

    def into_vector(self, vec) -> bool:
        """``vec[:] = self`` for the transform of a vector straight into
        the whole of ``vec`` (``vector.assign``'s direct path, no
        expression analysis): True; False where the general path must
        take it (an input that is not a vector of the plan's size, a
        target of another type or length, or one that shares the input's
        memory)."""
        x = self.children[0]
        if not isinstance(x, VectorTerminal):
            return False
        xt, out = x.vec.storage, vec.storage
        if (out.dtype != self.plan.dtype or out.numel() != self.plan.size
                or xt.numel() != self.plan.size or xt.device != out.device
                or xt.untyped_storage().data_ptr()
                == out.untyped_storage().data_ptr()):
            return False
        self.plan(xt, out)
        return True

    def _parts_io(self, ref):
        """(the input's part tensors in the plan's type, ``ref``'s
        points) over the partition of ``ref``; raises where the input is
        not of the plan's size."""
        from ..expr.compile import evaluate_parts

        if ref.size != self.plan.size:
            raise ValueError(f"FFT of {self.plan.size} points over "
                             f"{ref.size} elements")
        x = self.children[0]
        if isinstance(x, VectorTerminal) and x.vec.nparts > 1:
            from ..expr.compile import _same_partition

            _same_partition(x.vec, ref)
            xs = [p.to(self.plan.dtype) for p in x.vec.parts]
        else:
            xs = evaluate_parts(x, ref, self.plan.dtype).parts
        return xs, ref._pts

    def parts_into(self, target) -> bool:
        """``target[:] = self`` over the parts of a partitioned target of
        the transform's type: written part by part (``fft_dist``), the
        last all-to-all or the gathered result straight into its parts."""
        from .fft_dist import transform_parts

        if target.dtype != self.plan.dtype:
            return False
        xs, pts = self._parts_io(target)
        transform_parts(self.plan, xs, pts, target.parts)
        return True

    def materialize_parts(self, ref):
        """The transform over the parts of ``ref``'s partition: a new
        partitioned vector."""
        from ..vector import vector
        from .fft_dist import transform_parts

        xs, pts = self._parts_io(ref)
        outs = [torch.empty_like(x) for x in xs]
        transform_parts(self.plan, xs, pts, outs)
        return vector._from_parts(ref.context, pts, outs)

    def materialize(self, device: torch.device, n: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The transform on ``device`` (its input evaluated first where it
        is not a vector), flat; into ``out`` where it is given."""
        x = self.children[0]
        if isinstance(x, VectorTerminal):
            xt = x.vec.storage
        else:
            from ..expr.compile import evaluate

            xt = evaluate(x, n=self.plan.size, device=device)
        if xt.device != device:
            raise ValueError(f"FFT input on {xt.device}, evaluation on "
                             f"{device}")
        if xt.numel() != self.plan.size:
            raise ValueError(f"FFT of {self.plan.size} points over "
                             f"{xt.numel()} elements")
        return self.plan(xt, out).reshape(-1)

    def emit(self, env: EmitEnv):
        return self.materialize(env.device)


class FFT:
    """vex::FFT<T> (fft.hpp:40): an expression-terminal transform.

    ``dims`` selects the transformed axes; the others are batch axes (the
    reference's ``fft::none``).  A vector is the flattened row-major N-D
    array of ``shape``."""

    def __init__(self, shape: Union[int, Sequence[int]], *,
                 dims: Optional[Sequence[int]] = None, inverse: bool = False,
                 dtype: Any = None, impl: str = "xla", context=None):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(s) for s in shape)
        dtype = dtype_of(dtype) if dtype is not None else torch.complex64
        key = (shape, tuple(dims) if dims is not None else None, inverse,
               str(dtype), impl)
        self.plan = plan_cache.get_or_create(
            key, lambda: Plan(shape, dims, inverse, dtype, impl))

    def __call__(self, x) -> FFTExpr:
        return FFTExpr(self._route(x), x)

    def _route(self, x) -> Plan:
        """The four-step plan in place of an ``"xla"`` or ``"ct"`` one
        where ``x`` reads a partitioned vector whose parts the transform
        decomposes over (``vexcl_tpu/ops/fft.py:538-572``)."""
        from . import dispatch
        from .fft_dist import decomposes

        p = self.plan
        ref = dispatch.partitioned(as_expr(x)) if p.impl != "dist" else None
        if ref is None or not decomposes(p, ref._pts):
            return p
        key = (p.shape, p.dims, p.inverse, str(p.dtype), "dist")
        return plan_cache.get_or_create(
            key, lambda: Plan(p.shape, p.dims, p.inverse, p.dtype, "dist"))


def fft(x, **kwargs) -> FFTExpr:
    """One-shot ``y[:] = vex.fft(x)`` (1-D forward) of a vector."""
    return FFT(x.size, **kwargs)(x)


def ifft(x, **kwargs) -> FFTExpr:
    """One-shot ``y[:] = vex.ifft(x)`` (1-D inverse, scaled by 1/n)."""
    return FFT(x.size, inverse=True, **kwargs)(x)
