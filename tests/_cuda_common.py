"""What the card tests share (``tests/test_torch_cuda_*.py``, one file a
layer): the ``gpu`` and ``cpu`` contexts, the kernel-against-plain
comparisons, the bitwise checks and the profiler's count of device
records (``_kernels_launched``).  The files import neither jax nor
vexcl_tpu, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

Tolerances: f32 results may differ from the plain version by a few ulp
(FMA contraction, libdevice against PyTorch's own math, another summation
order): 2e-6 relative to the largest magnitude, 1e-5 for sums.  f64: 1e-12
and 1e-10 for sums.  The builtins' sweep holds each element within 4
times that of the plain value's magnitude (absolutely below 1).  MIN,
MAX, integer results and the DIA kernel on integer-valued data are
exact.  Scans: f32 sums 1e-5 relative to the
largest magnitude (another summation order), f64 1e-12, bf16 1e-2 (a sum
carried in f32 in another order may round to a neighbouring bf16);
MAX/MIN, integer scans and compaction bitwise; a scan repeated on the same
input (and alignment) bitwise; the keyed kernel bitwise against the route
it replaces (segment flags, segscan, compaction, the exclusive epilogue)
and within the scan tolerances of its plain versions.  Random numbers: Philox
words, uniforms and the known answers bitwise; normals (libdevice
log/cos/sqrt against PyTorch's) 8e-6 (f32), 4e-12 (f64) and 1e-2 (bf16,
where a few-ulp f32 difference may round to the neighbouring bf16).  User
kernels: 2e-7 for ``2*x + y`` (FMA contraction).
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from vexcl_tpu_torch.expr.compile import prepare
from vexcl_tpu_torch.expr.triton_emit import assign, assign_plain

N = (1 << 16) + 123
RTOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return vex.Context(vex.Filter.GPU)


def _vec(ctx, data):
    return vex.vector(data=data, context=ctx)


def _both(expr, n, dtype, device):
    """(kernel result, plain result) of one assignment."""
    e, analysis, types, leaves = prepare(expr, n, device)
    k = torch.empty(n, dtype=dtype, device=device)
    p = torch.empty(n, dtype=dtype, device=device)
    assign(e, analysis, types, leaves, k)
    assign_plain(e, analysis, types, leaves, p)
    torch.cuda.synchronize()
    return k, p


def _close(k, p, rtol):
    k, p = k.double().cpu(), p.double().cpu()
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    fin = ~torch.isnan(p)
    scale = max(1.0, p[fin].abs().max().item()) if fin.any() else 1.0
    err = (k[fin] - p[fin]).abs().max().item() if fin.any() else 0.0
    assert err <= rtol * scale, (err, scale)


def _close_each(k, p, rtol):
    """Element by element: each finite value within rtol of the plain
    value's magnitude (absolutely below 1), the non-finite ones equal."""
    k, p = k.double().cpu(), p.double().cpu()
    fin = torch.isfinite(p)
    assert torch.equal(torch.isfinite(k), fin)
    assert torch.equal(torch.isnan(k), torch.isnan(p))
    assert torch.equal(k[~fin & ~torch.isnan(p)], p[~fin & ~torch.isnan(p)])
    if fin.any():
        err = ((k[fin] - p[fin]).abs() / p[fin].abs().clamp_min(1.0)).max()
        assert err.item() <= rtol, err.item()


def _kernels_launched(fn, reps=3):
    """(name, count) of every device record (kernels and copies) of
    ``reps`` calls of fn, by torch.profiler.  The profiler drops a trace's first device records, more as the
    process ages, so spin kernels (``torch.cuda._sleep``) go first and
    take the loss, four times as many again until one of them is left
    (as ``chip_smoke.profile_call`` does)."""
    from torch.profiler import ProfilerActivity, profile

    for lead in (256, 1024, 4096, 16384):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        if any("spin_kernel" in key for key, _ in seen):
            return [(k, c) for k, c in seen if "spin_kernel" not in k]
    raise AssertionError("the profiler lost every lead-in record")


@pytest.fixture(scope="module")
def cpu():
    return vex.Context(vex.Filter.CPU, set_current=False)


def _bits(t):
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        t = t.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()])
    return t


def _bitwise(k, p):
    assert k.dtype == p.dtype and k.shape == p.shape
    assert torch.equal(_bits(k), _bits(p))


def _same(k, p):
    """Equal values, NaN where a NaN is (whatever its bits)."""
    k, p = k.cpu(), p.cpu()
    assert k.dtype == p.dtype and torch.equal(torch.isnan(k), torch.isnan(p))
    fin = ~torch.isnan(p)
    assert torch.equal(k[fin], p[fin])


def _host_data(n, dt, seed):
    rng = np.random.default_rng(seed)
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n)).to(dt)
    return torch.from_numpy(rng.integers(-1000, 1000, n)).to(dt)


def _on_both(gpu, cpu, fn, *arrays):
    """fn(*vectors) on the card and on the CPU from the same host data:
    [card results, CPU results], each the vectors' tensors on the CPU."""
    out = []
    for c in (gpu, cpu):
        vs = [vex.vector(data=a, context=c) for a in arrays]
        fn(*vs)
        torch.cuda.synchronize()
        out.append([v.storage.cpu() for v in vs])
    return out
