"""The whole slice: PoissonSolver and cg in the port against vexcl_tpu.

Both packages solve the 16³ Poisson problem (4096 unknowns) from the same
right-hand side, made with a numpy seed, for a fixed number of CG
iterations.  In f64 the two follow the same algorithm and may differ only
by the order of their sums: 1e-9 in the 2-norm of x.  The port's f32
solver keeps f32 vectors (the JAX package's f32 solver runs in bf16, the
dtype of its compressed planes), so it is held against the JAX f64 solve
at 1e-4.
"""

import numpy as np
import pytest
import torch

import vexcl_tpu as vex
import vexcl_tpu_torch as vt
from vexcl_tpu.models import PoissonSolver as JaxPoissonSolver
from vexcl_tpu_torch.models import PoissonSolver
from vexcl_tpu_torch.interop import cg, from_numpy, to_numpy


@pytest.fixture(scope="module")
def tctx():
    return vt.Context(vt.Filter.CPU, set_current=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("maxiter", [10, 40])
def test_poisson_solver_matches_jax_f64(ctx1, tctx, maxiter):
    n = 16
    f = np.random.default_rng(41).random(n ** 3)
    ju, jit = JaxPoissonSolver(n, dtype=np.float64, context=ctx1).solve(
        f, maxiter=maxiter)
    tu, tit = PoissonSolver(n, dtype=np.float64, context=tctx).solve(
        f, maxiter=maxiter)
    assert tit == jit == maxiter
    assert tu.dtype == torch.float64
    assert _rel(tu, ju) <= 1e-9


def test_poisson_solver_f32_keeps_f32(ctx1, tctx):
    n = 16
    f = np.random.default_rng(42).random(n ** 3)
    solver = PoissonSolver(n, dtype=np.float32, context=tctx)
    assert solver.A.device.vals.dtype == torch.bfloat16
    tu, _ = solver.solve(f, maxiter=40)
    assert tu.dtype == torch.float32
    ju, _ = JaxPoissonSolver(n, dtype=np.float64, context=ctx1).solve(
        f, maxiter=40)
    assert _rel(tu, ju) <= 1e-4


def test_cg_converges_like_jax(ctx1, tctx):
    """The stopping rule (r.r > tol^2 and it < maxiter) gives the same
    iteration count; the residual is checked through the port's SpMV."""
    n = 8
    f = np.ones(n ** 3)
    jsolver = JaxPoissonSolver(n, dtype=np.float64, context=ctx1)
    ju, jit = jsolver.solve(f, tol=1e-8, maxiter=1000)
    solver = PoissonSolver(n, dtype=np.float64, context=tctx)
    b = from_numpy(f, context=tctx)
    u, it = cg(solver.A, b, tol=1e-8, maxiter=1000)
    assert it == jit and 0 < it < 1000
    r = f - to_numpy(vt.vector(solver.A * u, context=tctx))
    assert np.linalg.norm(r) / np.linalg.norm(f) < 1e-5
    assert _rel(u, ju) <= 1e-9


def test_context_filters_select_explicit_devices():
    ctx = vt.Context(vt.Filter.CPU, set_current=False)
    assert ctx.device == torch.device("cpu") and ctx.size == 1
    assert vt.Context(device="cpu", set_current=False).device.type == "cpu"
    devs = [torch.device("cuda", 0), torch.device("cuda", 1),
            torch.device("cpu")]
    F = vt.Filter
    assert F.CPU(devs) == [torch.device("cpu")]
    assert F.GPU(devs) == devs[:2]
    assert (F.GPU & F.Position(1))(devs) == [devs[1]]
    assert (F.CPU | F.Count(1))(devs) == [devs[2], devs[0]]
    assert (~F.CPU)(devs) == devs[:2]
    assert F.Type("gpu")(devs) == devs[:2] and F.Platform("cpu")(devs) == [devs[2]]
    if not torch.cuda.is_available():
        # no silent fallback: asking for the card without one raises
        with pytest.raises(RuntimeError, match="no devices"):
            vt.Context(vt.Filter.GPU, set_current=False)


def test_context_env_filter(monkeypatch):
    devs = [torch.device("cuda", 0), torch.device("cpu")]
    monkeypatch.setenv("VEXTPU_PLATFORM", "cpu")
    assert vt.Filter.Env(devs) == [torch.device("cpu")]
    monkeypatch.delenv("VEXTPU_PLATFORM")
    monkeypatch.setenv("VEXTPU_MAX_DEVICES", "1")
    assert vt.Filter.Env(devs) == devs[:1]


def test_config_flags_and_purge(tctx, monkeypatch):
    from vexcl_tpu_torch.config import config

    a = vt.vector(10, context=tctx)
    b = vt.vector(11, context=tctx)
    with pytest.raises(ValueError, match="size mismatch"):
        a[:] = b + 1
    monkeypatch.setattr(config, "check_sizes", 0)
    with pytest.raises(ValueError):   # the leaf itself still must fit
        a[:] = b + 1
    vt.kernel_cache.get_or_create(("probe",), object)
    assert len(vt.kernel_cache) >= 1
    vt.purge_caches()
    assert len(vt.kernel_cache) == 0


def shifted_laplacian(n, ptr, col, val):
    """CSR of the shifted graph Laplacian of S: off-diagonal entries
    -(|S| + |S|^T), diagonal the absolute off-diagonal row sum + 1
    (symmetric, strictly diagonally dominant, so SPD)."""
    rows = np.repeat(np.arange(n), np.diff(ptr))
    off = rows != col
    a = np.abs(val[off])
    r = np.concatenate([rows[off], col[off], np.arange(n)])
    c = np.concatenate([col[off], rows[off], np.arange(n)])
    diag = np.bincount(r[:-n], weights=np.concatenate([a, a]), minlength=n)
    v = np.concatenate([-a, -a, diag + 1])
    order = np.argsort(r, kind="stable")
    lap_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return lap_ptr, c[order], v[order]


@pytest.mark.parametrize("fmt", [None, "sellr"])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cg_on_shifted_laplacian_matches_jax(ctx1, tctx, fmt, dt):
    """interop.cg on an unstructured SPD matrix: the port (CSR on a CPU
    context by default, or SELL-R) against vexcl_tpu.interop.cg in f64;
    f64 within 1e-9, the f32 solve within 1e-4."""
    from vexcl_tpu.interop import cg as jax_cg

    rng = np.random.default_rng(43)
    n = 3000
    lens = np.maximum(1, rng.lognormal(np.log(8) - 0.32, 0.8, n)).astype(int)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    col = rng.integers(0, n, int(ptr[-1]))
    val = rng.standard_normal(int(ptr[-1]))
    lp, lc, lv = shifted_laplacian(n, ptr, col, val)
    b = rng.random(n) - 0.5
    jA = vex.SpMat(n, n, lp, lc, lv, context=ctx1)
    ju, jit = jax_cg(jA, vex.vector(data=b, context=ctx1), tol=1e-10,
                     maxiter=100)
    tA = vt.SpMat(n, n, lp, lc, lv.astype(dt), fmt=fmt, context=tctx)
    assert tA.device.format == (fmt or "csr")
    tu, tit = cg(tA, from_numpy(b.astype(dt), context=tctx), tol=1e-10,
                 maxiter=100)
    assert tu.dtype == vt.dtype_of(dt) and 0 < jit
    if dt == np.float64:
        assert tit == jit
    assert _rel(tu, ju) <= (1e-9 if dt == np.float64 else 1e-4)
    r = b - to_numpy(vt.vector(tA * tu, context=tctx)).astype(np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
