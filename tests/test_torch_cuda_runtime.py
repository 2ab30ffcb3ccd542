"""The Philox kernel and the fused generators (known answers, against
their plain versions), the Monte-Carlo models, and the runtime: user
CUDA and Triton kernels, events, ``enqueue`` and dlpack, on the card.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_runtime.py

Tolerances: ``tests/_cuda_common.py``.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu_torch as vex
from _cuda_common import N, RTOL, gpu, cpu, _vec, _both, _close

pytestmark = pytest.mark.cuda


# -- the RNG: the Philox kernel, the fused generators, the known answers --

PHILOX_KATS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
THREEFRY_KATS = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0)),
]


def _words(t):
    return tuple(int(w) & 0xFFFFFFFF for w in t.cpu())


@pytest.mark.parametrize("source", ["iota", "counters"])
@pytest.mark.parametrize("nwords", [1, 2, 4])
def test_philox_bits_kernel_matches_plain(gpu, nwords, source):
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits, philox_bits_plain

    key, start = (0x89ABCDEF, 0x7), (1 << 32) - 1000
    ctr = None
    if source == "counters":
        ctr = torch.from_numpy(np.random.default_rng(13).integers(
            0, 1 << 40, N)).to(gpu.device)
    before = philox_bits.launches
    k = philox_bits(N, nwords, key, counters=ctr, start=start,
                    device=gpu.device)
    p = philox_bits_plain(N, nwords, key, counters=ctr, start=start,
                          device=gpu.device)
    torch.cuda.synchronize()
    assert philox_bits.launches == before + 1
    assert k.shape == (nwords, N) and torch.equal(k, p)


@pytest.mark.parametrize("kat", range(3))
def test_generator_known_answers_on_the_card(gpu, kat):
    """The Philox kernel and the rounds the expression kernel fuses give
    Random123's known answers."""
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits
    from vexcl_tpu_torch.ops.random import generator_rounds

    ctr, key, want = PHILOX_KATS[kat]
    planes = philox_bits(1, 4, key, c123=ctr[1:], counters=torch.tensor(
        [ctr[0]], device=gpu.device))
    assert _words(planes[:, 0]) == want
    got = generator_rounds("philox", torch.tensor(ctr, device=gpu.device)
                           .view(4, 1), torch.tensor(key, device=gpu.device)
                           .view(2, 1))
    assert _words(got[:, 0]) == want
    ctr, key, want = THREEFRY_KATS[kat]
    got = generator_rounds("threefry", torch.tensor(ctr, device=gpu.device)
                           .view(2, 1), torch.tensor(key, device=gpu.device)
                           .view(2, 1))
    assert _words(got[:, 0]) == want


@pytest.mark.parametrize("dt, normal", [
    (torch.float32, False), (torch.float64, False), (torch.bfloat16, False),
    (torch.int32, False), (torch.float32, True), (torch.float64, True),
    (torch.bfloat16, True)], ids=str)
@pytest.mark.parametrize("gen", ["philox", "threefry", "hw"])
def test_generators_kernel_match_plain(gpu, gen, dt, normal):
    """Fused generators against their plain versions: uniforms bitwise,
    normals within a few ulp (libdevice against PyTorch's log/cos)."""
    from vexcl_tpu_torch.ops.cuda_philox import philox_bits
    from vexcl_tpu_torch.ops.random import Random, RandomNormal

    rnd = (RandomNormal if normal else Random)(dt, gen)
    seed = (1 << 31) + 5
    before = philox_bits.launches
    k, p = _both(rnd(vex.element_index(7), seed), N, dt, gpu.device)
    assert philox_bits.launches == before + (gen == "hw")
    ref = rnd.plain(torch.arange(7, 7 + N, device=gpu.device), seed)
    assert torch.equal(p, ref)
    if normal:
        _close(k, p, 4 * RTOL.get(dt, 2e-6) if dt != torch.bfloat16 else 1e-2)
    else:
        assert torch.equal(k, p)
    if gen == "hw":
        x = vex.vector(N, dtype=dt, context=gpu)
        x[:] = (RandomNormal if normal else Random)(dt, "philox")(
            vex.element_index(7), seed)
        assert torch.equal(x.storage, k)


def test_generators_with_vector_seed_and_index(gpu):
    from vexcl_tpu_torch.ops.random import Random

    rng = np.random.default_rng(14)
    idx = _vec(gpu, rng.integers(0, 1 << 40, N))
    seeds = _vec(gpu, rng.integers(-(1 << 62), 1 << 62, N))
    for gen in ("philox", "threefry", "hw"):
        rnd = Random(torch.float64, gen)
        k, p = _both(rnd(idx, 99 if gen == "hw" else seeds), N,
                     torch.float64, gpu.device)
        assert torch.equal(k, p)
    with pytest.raises(ValueError, match="host integer seed"):
        vex.vector(N, context=gpu).assign(Random(torch.float32, "hw")(
            vex.element_index(), seeds))


def test_monte_carlo_models_on_the_card(gpu):
    from vexcl_tpu_torch.models import estimate_pi, gbm_terminal_mean

    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    n = 1 << 18
    assert estimate_pi(n, 5, context=gpu, dtype=torch.float64) == \
        estimate_pi(n, 5, context=cpu, dtype=torch.float64)
    a = gbm_terminal_mean(1 << 14, 8, context=gpu)
    b = gbm_terminal_mean(1 << 14, 8, context=cpu)
    assert abs(a - b) <= 1e-5 * abs(b)


# -- the runtime: user CUDA and Triton kernels, events, enqueue, dlpack --

USER_CUDA = r'''
extern "C" __global__ void triple(const float* x, float* y, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = 3.0f * x[i];
}
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
'''

USER_TRITON = '''import triton
import triton.language as tl


@triton.jit
def axpy(x_ptr, y_ptr, out_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m)
    tl.store(out_ptr + offs, 2.0 * x + tl.load(y_ptr + offs, mask=m), mask=m)
'''


def test_custom_kernel_cuda_and_triton_forms(gpu):
    from vexcl_tpu_torch._build import triton_module

    rng = np.random.default_rng(15)
    x, y = (_vec(gpu, rng.standard_normal(N).astype(np.float32))
            for _ in range(2))
    before = vex.CustomKernel.launches
    t = vex.CustomKernel(USER_CUDA, name="triple")(x)
    a = vex.CustomKernel(USER_CUDA, name="axpy")(x, y)
    b = vex.CustomKernel(triton_module(USER_TRITON).axpy, BLOCK=1024)(x, y)
    c = vex.backend.launch(USER_CUDA, x, name="triple", block=128)
    torch.cuda.synchronize()
    assert vex.CustomKernel.launches == before + 4
    assert t.context is gpu and torch.equal(t.storage, 3 * x.storage)
    assert torch.equal(c.storage, t.storage)
    ref = 2 * x.storage + y.storage
    _close(a.storage, ref, 2e-7)
    _close(b.storage, ref, 2e-7)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        vex.CustomKernel('extern "C" __global__ void bad(float* y) '
                         '{ y[0] = undefined; }')(x)


def test_events_enqueue_and_dlpack_on_the_card(gpu):
    cpu = vex.Context(vex.Filter.CPU, set_current=False)
    a = _vec(gpu, np.arange(N, dtype=np.float32))
    x = vex.vector(N, context=cpu)
    vex.enqueue(gpu)(x)[:] = 2 * a            # x migrates to the card
    ev = vex.enqueue_marker(gpu)
    ev.wait()
    assert ev.complete and x.context is gpu
    assert torch.equal(x.storage, 2 * a.storage)
    vex.enqueue(cpu)(x)[:] = x + 1            # and back to the CPU
    vex.enqueue_barrier(gpu)
    assert x.context is cpu and x.storage.device.type == "cpu"
    assert torch.equal(x.storage, (2 * a.storage + 1).cpu())
    y = vex.interop.from_dlpack(vex.interop.to_dlpack(a))
    assert y.storage.data_ptr() == a.storage.data_ptr()
    assert y.context.device == gpu.device
