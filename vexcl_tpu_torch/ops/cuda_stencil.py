"""1-D stencil: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``vexcl_tpu/ops/pallas_stencil.py::_kernel`` (called through
``stencil_pallas``): y[i] = sum_k c[k] * x[clamp(i + k - center, 0, n-1)],
the ends replicated as in vexcl/stencil.hpp:138-154.  The kernel,
``csrc/stencil.cu``, stages a tile of x with its halo in shared memory,
and reads wide taps through L2; it takes every width and center the API
accepts, any n (also n < width), and runs out of place (the expression
engine evaluates the stencil into a temporary, so ``x[:] = x * s`` reads
old values).

``stencil_apply`` is the wrapper: the plain version for CPU tensors, the
kernel for CUDA tensors with (x, taps) types in {f32, f64}²; the result
has the promoted type (f32 x with f64 taps gives f64, as ``jnp`` does).
Other pairs raise on CUDA.  The Pallas kernel's mesh-sharded local phase
(``stencil_pallas_dist``) waits for multi-device contexts.
"""

from __future__ import annotations

import ctypes

import torch

from ..types import promote

__all__ = ["stencil_apply", "stencil_plain", "result_dtype"]

_NAME = {torch.float32: "f32", torch.float64: "f64"}


def result_dtype(x_dtype: torch.dtype, coeff_dtype: torch.dtype) -> torch.dtype:
    """The stencil's value type: ``jnp.result_type(x, coeff)``."""
    return promote(x_dtype, coeff_dtype)


def _lib():
    from .._build import cuda_library

    lib = cuda_library("vexcl_stencil")
    if not getattr(lib, "_vex_bound", False):
        for a in _NAME.values():
            for b in _NAME.values():
                fn = getattr(lib, f"vex_stencil_{a}_{b}")
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.vex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vex_cuda_error_string.restype = ctypes.c_char_p
        lib._vex_bound = True
    return lib


def stencil_plain(x: torch.Tensor, coeff: torch.Tensor,
                  center: int) -> torch.Tensor:
    """Shifted slices of the edge-padded input, summed in tap order."""
    n, width = x.shape[0], coeff.shape[0]
    dt = result_dtype(x.dtype, coeff.dtype)
    y = torch.zeros(n, dtype=dt, device=x.device)
    if n == 0:
        return y
    idx = torch.arange(n + width - 1, device=x.device) - center
    xp = x[idx.clamp_(0, n - 1)].to(dt)
    c = coeff.to(device=x.device, dtype=dt)
    for k in range(width):
        y += c[k] * xp[k:k + n]
    return y


def stencil_apply(x: torch.Tensor, coeff: torch.Tensor,
                  center: int) -> torch.Tensor:
    """y = the stencil ``coeff`` (centred at ``center``) over ``x``;
    ``coeff`` lies on x's device."""
    width = coeff.shape[0]
    if x.ndim != 1 or coeff.ndim != 1 or not 0 <= center < width:
        raise ValueError(f"stencil of {width} taps centred at {center} over "
                         f"a tensor of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stencil_plain(x, coeff, center)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no stencil kernel for {x.device}")
    a, b = _NAME.get(x.dtype), _NAME.get(coeff.dtype)
    if a is None or b is None:
        raise NotImplementedError(
            f"stencil kernel has no form for {x.dtype} x with {coeff.dtype} "
            "taps")
    if coeff.device != x.device or not (x.is_contiguous()
                                        and coeff.is_contiguous()):
        raise ValueError("stencil operands must be contiguous on one device")
    if width >= 2 ** 31:
        raise ValueError(f"stencil of {width} taps: the kernel takes fewer "
                         "than 2^31")
    n = x.shape[0]
    y = torch.empty(n, dtype=result_dtype(x.dtype, coeff.dtype),
                    device=x.device)
    if n == 0:
        return y
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"vex_stencil_{a}_{b}")(
            x.data_ptr(), coeff.data_ptr(), y.data_ptr(), n, width, center,
            stream)
    if rc != 0:
        raise RuntimeError("stencil kernel launch failed: "
                           + lib.vex_cuda_error_string(rc).decode())
    stencil_apply.launches += 1
    return y


#: launches of the CUDA kernel (not of the plain version)
stencil_apply.launches = 0
