"""The port's runtime against vexcl_tpu: custom kernels, events, enqueue,
the profiler, dlpack/torch/scipy interop and BiCGStab.

Inputs come from a numpy seed and go through both packages on the CPU.
``CustomKernel(traced=True)`` computes with PyTorch's and XLA's float
arithmetic: 1e-6 relative (f32).  BiCGStab follows the JAX package's
recurrences, with its scalars in f64 on the host: x within 1e-9 in the
2-norm (f64), the same iteration count.  The user CUDA and Triton routes
have no plain form; on the CPU they raise, and the card tests
(``test_torch_cuda_runtime.py``) launch them.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vj
import vexcl_tpu_torch as vt
from vexcl_tpu_torch import backend, interop

TWICE = r'''
extern "C" __global__ void twice(const float* x, float* y, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) y[i] = 3.0f * x[i];
}
'''


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


@pytest.mark.parametrize("how", ["kernel", "launch"])
def test_custom_kernel_traced_matches_jax(ctx1, tctx, how):
    rng = np.random.default_rng(21)
    ha, hb = (rng.random(512).astype(np.float32) for _ in range(2))
    ja, jb = (vj.vector(data=h, context=ctx1) for h in (ha, hb))
    ta, tb = (vt.vector(data=h, context=tctx) for h in (ha, hb))
    if how == "kernel":
        jy = vj.CustomKernel(lambda x: x * x + 1, traced=True)(ja)
        ty = vt.CustomKernel(lambda x: x * x + 1, traced=True)(ta)
    else:
        jy = vj.backend.launch(lambda x, y: x * y + y, ja, jb, traced=True)
        ty = vt.backend.launch(lambda x, y: x * y + y, ta, tb, traced=True)
    assert ty.context is tctx and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.to_numpy(), np.asarray(jy), rtol=1e-6)


def test_user_kernels_have_no_plain_form(tctx):
    x = vt.vector(data=np.arange(8, dtype=np.float32), context=tctx)
    before = vt.CustomKernel.launches
    with pytest.raises(NotImplementedError, match="no plain form"):
        vt.CustomKernel(TWICE)(x)

    class FakeJit:       # what a @triton.jit function looks like, by module
        pass
    FakeJit.__module__ = "triton.runtime.jit"
    with pytest.raises(NotImplementedError, match="no plain form"):
        vt.CustomKernel(FakeJit(), BLOCK=128)(x)
    assert vt.CustomKernel.launches == before
    with pytest.raises(TypeError):
        vt.CustomKernel(lambda t: t)            # a function needs traced=True


def test_cuda_source_kernel_names():
    two = TWICE + 'extern "C" __global__ void __launch_bounds__(128) ' \
                  'other(float* y) {}\n'
    assert backend._kernel_names(two) == ("twice", "other")
    assert backend.cuda_kernel(TWICE).name == "twice"
    assert backend.cuda_kernel(two, "other").name == "other"
    with pytest.raises(ValueError, match="name one"):
        backend.cuda_kernel(two)
    with pytest.raises(ValueError, match="no extern"):
        backend.cuda_kernel(TWICE, "thrice")
    assert backend._dim3(5) == (5, 1, 1) and backend._dim3((2, 3)) == (2, 3, 1)


def test_events_marker_barrier(ctx, tctx):
    for vex, c in ((vj, ctx), (vt, tctx)):
        x = vex.vector(1024, context=c)
        x[:] = 1.0
        ev = vex.enqueue_marker(c)
        ev.wait()
        assert ev.complete
        vex.enqueue_barrier(c)


def test_enqueue_matches_jax(ctx, ctx1, tctx, rng):
    ha, hx = rng.random(256), rng.random(256)
    ja = vj.vector(data=ha, context=ctx)
    jx = vj.vector(data=hx, context=ctx)
    vj.enqueue(ctx1)(jx)[:] = 2 * ja
    ta = vt.vector(data=ha, context=tctx)
    tx = vt.vector(data=hx, context=tctx)
    other = vt.Context(device="cpu", set_current=False)
    storage = tx.storage
    vt.enqueue(other)(tx)[:] = 2 * ta
    assert tx.storage is storage           # same device: written in place
    np.testing.assert_array_equal(tx.to_numpy(), np.asarray(jx))
    q = vt.enqueue(other)(tx)
    q += ta
    q *= 0.5
    np.testing.assert_allclose(tx.to_numpy(), 0.5 * (2 * ha + ha), rtol=1e-15)
    with pytest.raises(TypeError):
        vt.enqueue(other)(tx)[0] = 1.0
    with pytest.raises(TypeError, match="multivector"):
        vt.enqueue(other)([tx, ta])


def test_profiler_and_stopwatch(ctx, tctx):
    reports = []
    for vex, c in ((vj, ctx), (vt, tctx)):
        prof = vex.profiler("test", context=c)
        prof.tic_cpu("outer")
        prof.tic_cl("inner")
        x = vex.vector(1024, context=c)
        x[:] = 1.0
        prof.toc("inner")
        with pytest.raises(RuntimeError):
            prof.toc("inner")               # "outer" is the open span
        prof.toc("outer")
        reports.append([ln.split(":")[0] for ln in str(prof).splitlines()])
        w = vex.stopwatch()
        w.tic()
        assert w.toc() >= 0 and w.laps == 1
        with pytest.raises(RuntimeError):
            w.toc()
    assert reports[0] == reports[1] == ["[test]", "  outer", "    inner"]


def test_dlpack_and_torch_share_storage(ctx1, tctx):
    x = vt.vector(data=np.arange(16, dtype=np.float32), context=tctx)
    y = interop.from_dlpack(interop.to_dlpack(x), context=tctx)
    assert y.storage.data_ptr() == x.storage.data_ptr()
    y[:] = 2 * y
    np.testing.assert_array_equal(x.to_numpy(), 2 * np.arange(16))
    t = interop.to_torch(x)
    assert t is x.storage
    z = interop.from_torch(t, context=tctx)
    assert z.storage.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(z.to_numpy(), x.to_numpy())
    # a JAX array crosses by dlpack too
    h = np.random.default_rng(6).random(64)
    j = vj.vector(data=h, context=ctx1)
    w = interop.from_dlpack(j.array)
    assert w.context.device.type == "cpu"
    np.testing.assert_array_equal(w.to_numpy(), h)


def _nonsymmetric_csr(n, seed):
    """A random non-symmetric, diagonally dominant CSR matrix."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        c = np.unique(rng.integers(0, n, 5))
        c = c[c != i]
        v = rng.standard_normal(c.size)
        rows += [i] * (c.size + 1)
        cols += [*c, i]
        vals += [*v, 1.0 + np.abs(v).sum()]
    order = np.lexsort((cols, rows))
    rows, cols, vals = (np.asarray(a)[order] for a in (rows, cols, vals))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return ptr, cols.astype(np.int64), vals.astype(np.float64)


def test_as_linear_operator_matches_jax(ctx1, tctx):
    n = 300
    ptr, col, val = _nonsymmetric_csr(n, 7)
    JA = vj.SpMat(n, n, ptr, col, val, context=ctx1)
    TA = vt.SpMat(n, n, ptr, col, val, context=tctx)
    x = np.random.default_rng(8).random(n)
    jop, top = vj.interop.as_linear_operator(JA), interop.as_linear_operator(TA)
    assert top.shape == (n, n) and top.dtype == np.float64
    np.testing.assert_allclose(top.matvec(x), jop.matvec(x), rtol=1e-13)


def test_bicgstab_matches_jax_f64(ctx1, tctx):
    n = 400
    ptr, col, val = _nonsymmetric_csr(n, 9)
    b = np.random.default_rng(10).random(n) - 0.5
    jx, jit = vj.interop.bicgstab(vj.SpMat(n, n, ptr, col, val, context=ctx1),
                                  vj.vector(data=b, context=ctx1), tol=1e-10)
    TA = vt.SpMat(n, n, ptr, col, val, context=tctx)
    tx, tit = interop.bicgstab(TA, vt.vector(data=b, context=tctx), tol=1e-10)
    assert tit == int(jit) and 0 < tit < 100
    x, xr = tx.to_numpy(), np.asarray(jx)
    assert np.linalg.norm(x - xr) <= 1e-9 * np.linalg.norm(xr)
    r = b - TA._matvec(tx.storage).numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)


def test_exclusive_filter_two_processes(tmp_path, monkeypatch):
    """Filter.Exclusive (opencl/filter.hpp:214-330) as the JAX package's:
    with one lock directory, the CPU device this process holds is not
    selected by a second process, and is once this process releases it;
    the lock files are keyed alike (the device's type and index)."""
    import os
    import subprocess
    import sys

    from vexcl_tpu_torch.context import release_exclusive_locks

    monkeypatch.setenv("VEXTPU_LOCK_DIR", str(tmp_path))
    mine = vt.Filter.Exclusive(vt.Filter.CPU).select(
        [torch.device("cpu")])
    assert mine == [torch.device("cpu")]
    # held already: this process selects it again
    c = vt.Context(vt.Filter.Exclusive(vt.Filter.CPU), set_current=False)
    assert c.device == torch.device("cpu")
    assert os.listdir(tmp_path) == ["vextpu_device_cpu_0.lock"]
    child = ("import torch, vexcl_tpu_torch as vt\n"
             "sel = vt.Filter.Exclusive(vt.Filter.CPU).select("
             "[torch.device('cpu')])\n"
             "print('GOT', len(sel))\n")
    env = dict(os.environ, VEXTPU_LOCK_DIR=str(tmp_path))
    runs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", child], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        runs.append(out.stdout.strip())
        release_exclusive_locks()
    assert runs == ["GOT 0", "GOT 1"]
