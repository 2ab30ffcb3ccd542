#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vexcl_tpu_torch``) on one GPU.

Drives the port's main path through its public API and holds each of its
six hand-written kernels against its plain PyTorch version on the same
inputs:

    python3 chip_smoke.py [--seed 0] [--json results.json]

Phases: (1) the card and the kernel builds (one nvcc per CUDA source, all
at once); (2) expressions and reductions at N = 2^24 (and 2^24 + 12345
for the reduction tail) in f32 and f64, MIN and MAX with a NaN too; (3)
the DIA SpMV on Poisson 256^3 (bf16 planes with f32 x, f64 planes with
f64 x); (4) ``PoissonSolver(256).solve(f, maxiter=100)`` in f32 against
the same CG in plain PyTorch f64 on the card; (5) the 1-D stencil at the
bench's 2^26 f32 configuration (width 5), in place too, an asymmetric
255-tap stencil, f64, a ``StencilOperator`` and n < width; (6) the
irregular SpMV on the bench's lognormal matrix (2^20 rows, ~16.3M
entries) through ``SpMat``, which picks SELL-R, in f32 and f64, and the
csr, ell and hyb formats; (7) ``SpMatCCSR`` on Poisson 64^3 and 256^3
against the DIA ``SpMat``; (8) ``interop.cg`` in f32 on the shifted graph
Laplacian of the phase-6 matrix (~33M entries) against the same CG in
plain PyTorch f64 on the card.  Each phase's launch counters are set to
0 just before its API run and read just after.  Times come from CUDA
events (kernels) or the host clock around synchronised work (solves,
construction).

Tolerances, relative to the largest magnitude of the plain result:
f32 elementwise 1e-5 and f64 1e-12 (a few ulp: FMA contraction,
libdevice against PyTorch's math); sums 1e-5 (f32, another summation
order over 2^24 terms) and 1e-10 (f64); MIN and MAX exact, NaN where a
NaN is; the DIA kernel 1e-6 (f32) and 1e-12 (f64); the stencil 1e-5
(f32; 1e-4 for 255 taps) and 1e-12 (f64); the SELL and CSR kernels 1e-5
(f32, rows summed in another order) and 1e-12 (f64).  The f32 CGs against
the f64 CGs: 1e-3 (Poisson) and 1e-4 (Laplacian) in the 2-norm of x, by
rounding alone.  The right-hand sides are zero-mean noise; the true
residual |b - A x| must fall at least 20-fold (Poisson, 100 iterations)
and 10^4-fold (Laplacian, to 1e-6 |b| or 100 iterations).

Any failed check raises, and the script exits non-zero without the
result line; it also fails when no CUDA device is visible and when the
package is not next to it.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_VEC = 1 << 24
TAIL = 12345
POISSON_N = 256
CG_ITERS = 100
CG_X_TOL = 1e-3
CG_RESIDUAL_DROP = 20.0
TOL = {"f32": 1e-5, "f64": 1e-12}
SUM_TOL = {"f32": 1e-5, "f64": 1e-10}
DIA_TOL = {"f32": 1e-6, "f64": 1e-12}
STENCIL_N = 1 << 26
STENCIL_N_SMALL = 1 << 24
STENCIL_TOL = {"f32": 1e-5, "f32_wide": 1e-4, "f64": 1e-12}
RANDOM_N = 1 << 20
SPMV_TOL = {"f32": 1e-5, "f64": 1e-12}
LAPLACE_CG_TOL = 1e-6         # stop at |r| <= 1e-6 |b| ...
LAPLACE_X_TOL = 1e-4          # ... and hold x within 1e-4 of the f64 CG
LAPLACE_RESIDUAL_DROP = 1e4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of fn() over reps launches, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_lognormal_csr(n, mean=16.0, sigma=0.8, seed=0):
    """The bench's irregular matrix (bench.py ``_random_lognormal_csr``):
    lognormal row lengths (mean ~16), uniform random columns, f32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mu = np.log(mean) - sigma * sigma / 2
    lens = np.maximum(1, rng.lognormal(mu, sigma, n).astype(np.int64))
    ptr = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(ptr[-1])
    col = rng.integers(0, n, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    return ptr, col, val, nnz


def shifted_laplacian(n, ptr, col, val):
    """CSR of the shifted graph Laplacian of S: off-diagonal entries
    -(|S| + |S|^T), diagonal the absolute off-diagonal row sum + 1
    (symmetric and strictly diagonally dominant, hence SPD)."""
    import numpy as np

    rows = np.repeat(np.arange(n), np.diff(ptr))
    off = rows != col
    a = np.abs(val[off]).astype(np.float64)
    r = np.concatenate([rows[off], col[off], np.arange(n)])
    c = np.concatenate([col[off], rows[off], np.arange(n)])
    diag = np.bincount(r[:-n], weights=np.concatenate([a, a]), minlength=n)
    v = np.concatenate([-a, -a, diag + 1])
    order = np.argsort(r, kind="stable")
    lap_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return lap_ptr, c[order], v[order]


def plain_cg(mv, b, tol, maxiter):
    """CG in plain PyTorch with the port's stopping rule."""
    import torch

    x = torch.zeros_like(b)
    r = b - mv(x)
    p = r.clone()
    rs = torch.dot(r, r).item()
    it = 0
    while rs > tol * tol and it < maxiter:
        Ap = mv(p)
        alpha = rs / torch.dot(p, Ap).item()
        x += alpha * p
        r -= alpha * Ap
        rs_new = torch.dot(r, r).item()
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it


def errors(k, p):
    """(max abs error, max abs error / max |plain|) in f64."""
    import torch

    k, p = k.double(), p.double()
    check(torch.isfinite(k).all().item(), "kernel result is not finite")
    abs_err = (k - p).abs().max().item()
    return abs_err, abs_err / max(p.abs().max().item(), 1e-300)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="also write every result to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import vexcl_tpu_torch as vex

    check(os.path.dirname(os.path.abspath(vex.__file__)).startswith(HERE),
          "vexcl_tpu_torch does not come from this checkout")
    check("jax" not in sys.modules and "vexcl_tpu" not in sys.modules,
          "the port imported jax or vexcl_tpu")
    from vexcl_tpu_torch._build import build_cuda_libraries
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import assign, assign_plain
    from vexcl_tpu_torch.models import PoissonSolver
    from vexcl_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_plain
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce, map_reduce_plain
    from vexcl_tpu_torch.sparse.cuda_dia import dia_matvec, dia_matvec_plain
    from vexcl_tpu_torch.sparse.cuda_sell import (csr_spmv, csr_spmv_plain,
                                                  sell_spmv, sell_spmv_plain)
    from vexcl_tpu_torch.utils.poisson import poisson_7pt, poisson_7pt_ccsr

    results = {"seed": args.seed}
    counters = {"expr": assign, "reduce": map_reduce, "dia": dia_matvec,
                "stencil": stencil_apply, "sell": sell_spmv,
                "csr": csr_spmv}
    main_launches = {}

    def counted(keys, fn):
        """Run fn (a main path) with the counters of ``keys`` at 0 before
        it; return its result and the launches, each checked > 0."""
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: counters[k].launches for k in keys}
        check(all(v > 0 for v in got.values()),
              f"a kernel of the path never launched: {got}")
        return out, got
    smi = smi_line()
    print(smi)
    results["card"] = smi
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def rand(n, dt):
        return vex.vector(data=torch.rand(n, generator=gen, device=dev,
                                          dtype=dt), context=ctx)

    # -- phase 1: builds ----------------------------------------------------
    t = time.perf_counter()
    build_cuda_libraries()
    nvcc_s = time.perf_counter() - t
    t = time.perf_counter()
    for dt in (torch.float32, torch.float64):
        a, b, c = (rand(4096, dt) for _ in range(3))
        a[:] = 2 * b + vex.sin(c)
        a += b + c * b
        for kind in (vex.SUM, vex.MIN, vex.MAX):
            vex.Reductor(kind)(a * b)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t
    print(f"build: nvcc {nvcc_s:.2f} s, triton (first kernels) "
          f"{triton_s:.2f} s")
    results["build_s"] = {"nvcc": nvcc_s, "triton_first": triton_s}

    def time_assign(expr, out):
        e, an, ty, lv = prepare(expr, out.numel(), dev)
        plain = torch.empty_like(out)
        kern = torch.empty_like(out)
        assign(e, an, ty, lv, kern)
        assign_plain(e, an, ty, lv, plain)
        ms = cuda_ms(lambda: assign(e, an, ty, lv, kern))
        plain_ms = cuda_ms(lambda: assign_plain(e, an, ty, lv, plain))
        return kern, plain, ms, plain_ms

    def report(tag, rec):
        print(f"{tag}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rec.items()))
        results[tag] = rec

    # -- phase 2: expressions and reductions at 2^24 ------------------------
    for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
        x, y, z = (rand(N_VEC, dt) for _ in range(3))
        x[:] = 2 * y + vex.sin(z)
        kern, plain, ms, plain_ms = time_assign(2 * y + vex.sin(z),
                                                x.storage)
        _, rel = errors(x.storage, plain)
        check(rel <= TOL[dname], f"{dname} 2*y+sin(z): rel err {rel}")
        api_ms = cuda_ms(lambda: x.assign(2 * y + vex.sin(z)))
        report(f"expr_saxpy_sin_{dname}", {"max_rel_err": rel, "ms": ms,
                                           "plain_ms": plain_ms,
                                           "api_ms": api_ms})

        a, b, c, d = (rand(N_VEC, dt) for _ in range(4))
        a0 = vex.vector(data=a.storage, context=ctx)  # the old value
        a += b + c * d
        e, an, ty, lv = prepare(a0 + (b + c * d), N_VEC, dev)
        ref = torch.empty_like(a0.storage)
        assign_plain(e, an, ty, lv, ref)
        _, rel = errors(a.storage, ref)
        check(rel <= TOL[dname], f"{dname} a += b + c*d: rel err {rel}")
        kern, plain, ms, plain_ms = time_assign(a + (b + c * d), a.storage)
        report(f"expr_a_plus_bcd_{dname}", {"max_rel_err": rel, "ms": ms,
                                            "plain_ms": plain_ms})
        del a, b, c, d, a0, ref, kern, plain

        for n in (N_VEC, N_VEC + TAIL):
            u, v = rand(n, dt), rand(n, dt)
            v[:] = v - 0.5
            e, an, ty, lv = prepare(u * v, n, dev)
            for kind in ("SUM", "MIN", "MAX"):
                api = vex.Reductor(getattr(vex, kind))(u * v)
                k = map_reduce(e, an, ty, lv, n, kind, dev).item()
                p = map_reduce_plain(e, an, ty, lv, n, kind, dev).item()
                check(api == k, f"Reductor({kind}) differs from its kernel")
                err = abs(k - p)
                tol = SUM_TOL[dname] * max(1.0, abs(p)) if kind == "SUM" else 0
                check(err <= tol, f"{dname} {kind}(x*y) n={n}: {k} vs {p}")
                ms = cuda_ms(lambda: map_reduce(e, an, ty, lv, n, kind, dev))
                plain_ms = cuda_ms(lambda: map_reduce_plain(e, an, ty, lv, n,
                                                            kind, dev))
                report(f"reduce_{kind}_{dname}_n{n}", {
                    "kernel": k, "plain": p, "abs_err": err, "ms": ms,
                    "plain_ms": plain_ms})
        # MIN and MAX propagate NaN (one in the last, partial block)
        v.storage[N_VEC + TAIL - 3] = float("nan")
        e, an, ty, lv = prepare(u * v, n, dev)
        for kind in ("MIN", "MAX"):
            k = map_reduce(e, an, ty, lv, n, kind, dev).item()
            p = map_reduce_plain(e, an, ty, lv, n, kind, dev).item()
            check(k != k and p != p, f"{dname} {kind} with a NaN: {k}, {p}")
            report(f"reduce_{kind}_{dname}_nan", {"kernel": k, "plain": p})
        del x, y, z, u, v
        torch.cuda.empty_cache()

    # -- phase 3: the SpMV on Poisson 256^3 ---------------------------------
    nrows = POISSON_N ** 3
    kernels = {}
    for dname, npdt, dt in (("f32", np.float32, torch.float32),
                            ("f64", np.float64, torch.float64)):
        t = time.perf_counter()
        ptr, col, val = poisson_7pt(POISSON_N, dtype=npdt)
        A = vex.SpMat(nrows, nrows, ptr, col, val, context=ctx)
        del ptr, col, val
        build_s = time.perf_counter() - t
        D = A.device
        want = torch.bfloat16 if dname == "f32" else torch.float64
        check(D.format == "dia" and D.vals.dtype == want,
              f"Poisson {dname}: SpMat picked {D.format}/{D.vals.dtype}")
        x, y = rand(nrows, dt), rand(nrows, dt)
        y0 = y.storage.clone()
        y[:] = 0.5 * (A * x) + y
        ref = 0.5 * dia_matvec_plain(D.n, D.m, D.offsets, D.vals,
                                     x.storage) + y0
        _, rel_expr = errors(y.storage, ref)
        check(rel_expr <= DIA_TOL[dname] * 4,
              f"{dname} y = 0.5*(A*x) + y: rel err {rel_expr}")
        k = dia_matvec(D.n, D.m, D.offsets, D.offsets_dev, D.vals, x.storage)
        p = dia_matvec_plain(D.n, D.m, D.offsets, D.vals, x.storage)
        abs_err, rel = errors(k, p)
        check(rel <= DIA_TOL[dname], f"{dname} DIA kernel: rel err {rel}")
        ms = cuda_ms(lambda: dia_matvec(D.n, D.m, D.offsets, D.offsets_dev,
                                        D.vals, x.storage))
        plain_ms = cuda_ms(lambda: dia_matvec_plain(D.n, D.m, D.offsets,
                                                    D.vals, x.storage))
        api_ms = cuda_ms(lambda: y.assign(0.5 * (A * x) + y))
        rec = {"planes": str(D.vals.dtype), "host_build_s": build_s,
               "max_abs_err": abs_err, "max_rel_err": rel,
               "expr_max_rel_err": rel_expr, "ms": ms, "plain_ms": plain_ms,
               "expr_api_ms": api_ms,
               "gflops": 2 * A.nnz / (ms * 1e-3) / 1e9}
        report(f"spmv_poisson256_{dname}", rec)
        if dname == "f32":
            kernels["dia"] = (abs_err, ms, plain_ms)
            A_poisson256 = A      # the DIA SpMat that phase 7 compares with
        del A, D, x, y, y0, ref, k, p
        torch.cuda.empty_cache()

    # -- phase 4: PoissonSolver(256).solve(f, maxiter=100) in f32 -----------
    t = time.perf_counter()
    solver = PoissonSolver(POISSON_N, context=ctx)
    construct_s = time.perf_counter() - t
    D = solver.A.device
    check(D.format == "dia" and D.vals.dtype == torch.bfloat16,
          "PoissonSolver's SpMat is not DIA with bf16 planes")
    # zero-mean noise: on a smooth right-hand side (say U[0,1)) CG's
    # residual first GROWS for many iterations at this size (A-norm error
    # falls, the 2-norm residual need not), so no residual drop could be
    # asked of 100 iterations
    f = (np.random.default_rng(args.seed).random(nrows) - 0.5).astype(
        np.float32)
    # a 3-iteration solve first compiles the solver's Triton kernels, so
    # the timed solve measures the iterations alone
    t = time.perf_counter()
    solver.solve(f, maxiter=3)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    (u, iters), launches = counted(("expr", "reduce", "dia"),
                                   lambda: solver.solve(f, maxiter=CG_ITERS))
    solve_s = time.perf_counter() - t
    main_launches.update(launches)
    check(iters == CG_ITERS, f"CG stopped after {iters} iterations")

    # the same CG in plain PyTorch f64 on the card
    vals64 = D.vals.to(torch.float64)
    b64 = torch.from_numpy(f).to(dev, torch.float64)

    def mv(v):
        return dia_matvec_plain(D.n, D.m, D.offsets, vals64, v)

    torch.cuda.synchronize()
    t = time.perf_counter()
    xr, it = plain_cg(mv, b64, 1e-6, CG_ITERS)
    torch.cuda.synchronize()
    plain_solve_s = time.perf_counter() - t
    x64 = u.storage.to(torch.float64)
    check(torch.isfinite(x64).all().item(), "CG solution is not finite")
    x_rel = (torch.linalg.vector_norm(x64 - xr)
             / torch.linalg.vector_norm(xr)).item()
    res_rel = (torch.linalg.vector_norm(b64 - mv(x64))
               / torch.linalg.vector_norm(b64)).item()
    check(x_rel <= CG_X_TOL, f"CG x differs from the f64 CG by {x_rel}")
    check(res_rel <= 1 / CG_RESIDUAL_DROP,
          f"CG residual fell only to {res_rel} of |b|")
    report("cg_poisson256_f32", {
        "iterations": iters, "ms_per_iter": solve_s / iters * 1e3,
        "plain_f64_ms_per_iter": plain_solve_s / it * 1e3,
        "host_construct_s": construct_s, "first_3_iters_s": warm_s,
        "x_rel_err_vs_f64": x_rel,
        "residual_over_b": res_rel, "launches": launches})

    # kernel times at the main path's shapes (256^3, f32)
    pv, rv, Apv = (rand(nrows, torch.float32) for _ in range(3))
    kern, plain, ms, plain_ms = time_assign(rv + 0.7 * pv, pv.storage)
    kernels["expr"] = (errors(kern, plain)[0], ms, plain_ms)
    e, an, ty, lv = prepare(pv * Apv, nrows, dev)
    k = map_reduce(e, an, ty, lv, nrows, "SUM", dev).item()
    p_ = map_reduce_plain(e, an, ty, lv, nrows, "SUM", dev).item()
    kernels["reduce"] = (
        abs(k - p_), cuda_ms(lambda: map_reduce(e, an, ty, lv, nrows, "SUM",
                                                dev)),
        cuda_ms(lambda: map_reduce_plain(e, an, ty, lv, nrows, "SUM", dev)))

    del solver, u, pv, rv, Apv, xr, b64, vals64, x64
    torch.cuda.empty_cache()

    # -- phase 5: the 1-D stencil -------------------------------------------
    # the bench's configuration (bench.py:174-183): 2^26 f32, 5 taps
    c = np.linspace(0.1, 0.5, 5)
    taps = (c / c.sum()).astype(np.float32)
    st = vex.stencil(taps, center=2)
    x = rand(STENCIL_N, torch.float32)
    y = vex.vector(STENCIL_N, dtype=torch.float32, context=ctx)
    x0 = x.storage.clone()

    def stencil_api():
        y[:] = x * st
        x[:] = x * st                 # in place: reads the old x
    _, launches = counted(("stencil", "expr"), stencil_api)
    main_launches["stencil"] = launches["stencil"]
    cdev = st.coeff_on(dev)
    ref = stencil_plain(x0, cdev, 2)
    for name, got in (("y = x*s", y.storage), ("x = x*s", x.storage)):
        _, rel = errors(got, ref)
        check(rel <= STENCIL_TOL["f32"], f"stencil {name}: rel err {rel}")
    k = stencil_apply(x0, cdev, 2)
    abs_err, rel = errors(k, ref)
    check(rel <= STENCIL_TOL["f32"], f"stencil kernel: rel err {rel}")
    ms = cuda_ms(lambda: stencil_apply(x0, cdev, 2))
    plain_ms = cuda_ms(lambda: stencil_plain(x0, cdev, 2))
    api_ms = cuda_ms(lambda: y.assign(x * st))
    kernels["stencil"] = (abs_err, ms, plain_ms)
    nbytes = 2 * STENCIL_N * 4
    report("stencil_2^26_w5_f32", {
        "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms, "api_ms": api_ms, "launches": launches,
        "GBs": nbytes / (ms * 1e-3) / 1e9,
        "plain_GBs": nbytes / (plain_ms * 1e-3) / 1e9})
    del x, y, x0, ref, k
    torch.cuda.empty_cache()

    ns = STENCIL_N_SMALL
    g = np.random.default_rng(args.seed + 5)
    for tag, n, tp, center, dt, tol in (
            ("w255_c40_f32", ns, (g.random(255) - 0.5).astype(np.float32),
             40, torch.float32, STENCIL_TOL["f32_wide"]),
            ("w5_f64", ns, c / c.sum(), 2, torch.float64, STENCIL_TOL["f64"]),
            ("n3_w5_f32", 3, taps, 2, torch.float32, STENCIL_TOL["f32"])):
        s_ = vex.stencil(tp, center=center)
        x = rand(n, dt)
        y = vex.vector(n, dtype=dt, context=ctx)
        y[:] = x * s_
        cd = s_.coeff_on(dev)
        ref = stencil_plain(x.storage, cd, center)
        abs_err, rel = errors(y.storage, ref)
        check(rel <= tol, f"stencil {tag}: rel err {rel}")
        rec = {"max_abs_err": abs_err, "max_rel_err": rel}
        if n > 1000:
            rec["ms"] = cuda_ms(lambda: stencil_apply(x.storage, cd, center))
            rec["plain_ms"] = cuda_ms(lambda: stencil_plain(x.storage, cd,
                                                            center))
            rec["GBs"] = 2 * n * x.storage.element_size() / (
                rec["ms"] * 1e-3) / 1e9
        report(f"stencil_{tag}", rec)

    op = vex.StencilOperator(3, 1, lambda X: X[0] + (X[-1] + X[1]) ** 3)
    x = rand(ns, torch.float32)
    y = vex.vector(ns, dtype=torch.float32, context=ctx)
    _, launches = counted(("expr",), lambda: y.assign(op(x)))
    xs = x.storage
    tp_ = torch.cat([xs[:1], xs, xs[-1:]])
    ref = tp_[1:-1] + (tp_[:-2] + tp_[2:]) ** 3
    abs_err, rel = errors(y.storage, ref)
    check(rel <= STENCIL_TOL["f32"], f"StencilOperator: rel err {rel}")
    report("stencil_operator_f32", {
        "max_abs_err": abs_err, "max_rel_err": rel, "launches": launches,
        "api_ms": cuda_ms(lambda: y.assign(op(x)))})
    del x, y, xs, tp_, ref
    torch.cuda.empty_cache()

    # -- phase 6: the irregular SpMV on the bench's lognormal matrix ---------
    t = time.perf_counter()
    ptr, col, val, nnz = random_lognormal_csr(RANDOM_N, seed=args.seed)
    results["random_matrix"] = {"n": RANDOM_N, "nnz": nnz,
                                "generate_s": time.perf_counter() - t}

    def sell_plain(D, xt):
        yp = sell_spmv_plain(D.n, D.slice_ptr, D.col, D.val, D.perm, xt)
        if D.tail is not None:
            T = D.tail
            csr_spmv_plain(D.n, T.ptr, T.col, T.val, xt, T.rows, out=yp)
        return yp

    csr_ref = None
    for dname, npdt, dt in (("f32", np.float32, torch.float32),
                            ("f64", np.float64, torch.float64)):
        t = time.perf_counter()
        A = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val.astype(npdt),
                      context=ctx)
        build_s = time.perf_counter() - t
        D = A.device
        check(D.format == "sellr", f"{dname} lognormal: SpMat picked "
              f"{D.format}, not sellr")
        x, y = rand(RANDOM_N, dt), rand(RANDOM_N, dt)
        y0 = y.storage.clone()
        sums = {}

        def spmv_api():
            y[:] = A * x
            sums["first"] = y.storage.clone()
            y[:] = 2 * (A * x) + y
        keys = ("sell", "csr") if D.tail is not None else ("sell",)
        _, launches = counted(keys, spmv_api)
        if dname == "f32":
            main_launches["sell"] = launches["sell"]
        ref = sell_plain(D, x.storage)
        _, rel1 = errors(sums["first"], ref)
        _, rel2 = errors(y.storage, 3 * ref)
        check(max(rel1, rel2) <= 4 * SPMV_TOL[dname],
              f"{dname} sellr y = A*x / 2*(A*x)+y: rel err {rel1}, {rel2}")
        k = sell_spmv(D.n, D.slice_ptr, D.col, D.val, D.perm, x.storage)
        p = sell_spmv_plain(D.n, D.slice_ptr, D.col, D.val, D.perm, x.storage)
        abs_err, rel = errors(k, p)
        check(rel <= SPMV_TOL[dname], f"{dname} SELL kernel: rel err {rel}")
        ms = cuda_ms(lambda: sell_spmv(D.n, D.slice_ptr, D.col, D.val,
                                       D.perm, x.storage))
        plain_ms = cuda_ms(lambda: sell_spmv_plain(
            D.n, D.slice_ptr, D.col, D.val, D.perm, x.storage))
        apply_ms = cuda_ms(lambda: D.apply(x.storage))
        rec = {"host_build_s": build_s, "slots_over_nnz": D.slots / nnz,
               "tail_rows": 0 if D.tail is None else int(D.tail.rows.numel()),
               "tail_nnz": 0 if D.tail is None else D.tail.nnz,
               "max_abs_err": abs_err, "max_rel_err": rel,
               "expr_max_rel_err": max(rel1, rel2), "sell_ms": ms,
               "sell_plain_ms": plain_ms, "apply_ms": apply_ms,
               "gflops": 2 * nnz / (apply_ms * 1e-3) / 1e9,
               "launches": launches,
               "api_ms": cuda_ms(lambda: y.assign(A * x))}
        report(f"spmv_random_sellr_{dname}", rec)
        if dname == "f32":
            kernels["sell"] = (abs_err, ms, plain_ms)
            x32 = x
        del A, D, y, y0, ref, k, p
        torch.cuda.empty_cache()

    # the other formats, f32, against the plain CSR result
    for fmt in ("csr", "hyb", "ell"):
        t = time.perf_counter()
        A = vex.SpMat(RANDOM_N, RANDOM_N, ptr, col, val, fmt=fmt,
                      context=ctx)
        build_s = time.perf_counter() - t
        D = A.device
        y = vex.vector(RANDOM_N, dtype=torch.float32, context=ctx)
        _, launches = counted(("csr",) if fmt != "ell" else ("sell",),
                              lambda: y.assign(A * x32))
        rec = {"host_build_s": build_s, "launches": launches}
        if fmt == "csr":
            csr_ref = csr_spmv_plain(D.n, D.ptr, D.col, D.val, x32.storage)
            k = csr_spmv(D.n, D.ptr, D.col, D.val, x32.storage)
            abs_err, rel = errors(k, csr_ref)
            check(rel <= SPMV_TOL["f32"], f"CSR kernel: rel err {rel}")
            ms = cuda_ms(lambda: csr_spmv(D.n, D.ptr, D.col, D.val,
                                          x32.storage))
            plain_ms = cuda_ms(lambda: csr_spmv_plain(D.n, D.ptr, D.col,
                                                      D.val, x32.storage))
            kernels["csr"] = (abs_err, ms, plain_ms)
            main_launches["csr"] = launches["csr"]
            rec.update(max_abs_err=abs_err, max_rel_err=rel, ms=ms,
                       plain_ms=plain_ms,
                       gflops=2 * nnz / (ms * 1e-3) / 1e9)
        else:
            rec["slots_over_nnz"] = D.slots / nnz
            if fmt == "hyb":
                T = D.tail
                rec.update(ell_width=D.width, tail_rows=int(T.rows.numel()),
                           tail_nnz=T.nnz)
                base = sell_spmv(D.n, D.slice_ptr, D.col, D.val, D.perm,
                                 x32.storage)
                k = csr_spmv(D.n, T.ptr, T.col, T.val, x32.storage, T.rows,
                             out=base.clone())
                p = csr_spmv_plain(D.n, T.ptr, T.col, T.val, x32.storage,
                                   T.rows, out=base.clone())
                _, rel = errors(k, p)
                check(rel <= SPMV_TOL["f32"], f"hyb tail CSR: rel err {rel}")
                rec["tail_max_rel_err"] = rel
            ms = cuda_ms(lambda: D.apply(x32.storage))
            rec.update(ms=ms, gflops=2 * nnz / (ms * 1e-3) / 1e9)
        _, rel = errors(y.storage, csr_ref)
        check(rel <= SPMV_TOL["f32"], f"{fmt} vs plain CSR: rel err {rel}")
        rec["vs_plain_csr_max_rel_err"] = rel
        report(f"spmv_random_{fmt}_f32", rec)
        del A, D, y
        torch.cuda.empty_cache()
    del x32, csr_ref

    # -- phase 7: SpMatCCSR on Poisson 64^3 and 256^3 ------------------------
    for m in (64, POISSON_N):
        nr = m ** 3
        t = time.perf_counter()
        C = vex.SpMatCCSR(nr, nr, *poisson_7pt_ccsr(m, dtype=np.float32),
                          context=ctx)
        build_s = time.perf_counter() - t
        P = (A_poisson256 if m == POISSON_N else
             vex.SpMat(nr, nr, *poisson_7pt(m, dtype=np.float32),
                       context=ctx))
        if m == POISSON_N:
            check(C.cached_coeffs is not None
                  and C.cached_coeffs.dtype == torch.bfloat16,
                  "CCSR 256^3: the expansion is not cached as bf16 planes")
        x = rand(nr, torch.float32)
        y = vex.vector(nr, dtype=torch.float32, context=ctx)
        _, launches = counted(("dia",), lambda: y.assign(C * x))
        ref = P.device.apply(x.storage)
        abs_err, rel = errors(y.storage, ref)
        check(rel <= DIA_TOL["f32"], f"CCSR {m}^3 vs DIA SpMat: rel {rel}")
        ms = cuda_ms(lambda: C._matvec(x.storage))
        report(f"ccsr_poisson{m}_f32", {
            "host_build_s": build_s, "cached": C.cached_coeffs is not None,
            "planes": str(C.cached_coeffs.dtype), "max_abs_err": abs_err,
            "max_rel_err": rel, "ms": ms, "launches": launches,
            "gflops": 2 * 7 * nr / (ms * 1e-3) / 1e9})
        del C, P, x, y, ref
    del A_poisson256
    torch.cuda.empty_cache()

    # -- phase 8: CG on the shifted graph Laplacian of the phase-6 matrix ----
    t = time.perf_counter()
    lp, lc, lv = shifted_laplacian(RANDOM_N, ptr, col, val)
    A = vex.SpMat(RANDOM_N, RANDOM_N, lp, lc, lv.astype(np.float32),
                  context=ctx)
    build_s = time.perf_counter() - t
    D = A.device
    check(D.format == "sellr", f"Laplacian: SpMat picked {D.format}")
    del ptr, col, val
    b_host = (np.random.default_rng(args.seed + 8).random(RANDOM_N)
              - 0.5).astype(np.float32)
    b = vex.vector(data=b_host, context=ctx)
    tol = LAPLACE_CG_TOL * float(np.linalg.norm(b_host.astype(np.float64)))
    vex.interop.cg(A, b, tol=tol, maxiter=3)         # compiles the kernels
    keys = ("expr", "reduce", "sell") + (("csr",) if D.tail is not None
                                         else ())
    t = time.perf_counter()
    (u, iters), launches = counted(keys, lambda: vex.interop.cg(
        A, b, tol=tol, maxiter=CG_ITERS))
    solve_s = time.perf_counter() - t
    lap = {k: torch.from_numpy(a).to(dev) for k, a in
           (("ptr", lp), ("col", lc.astype(np.int32)), ("val", lv))}
    b64 = torch.from_numpy(b_host).to(dev, torch.float64)

    def lmv(v):
        return csr_spmv_plain(RANDOM_N, lap["ptr"], lap["col"], lap["val"], v)

    torch.cuda.synchronize()
    t = time.perf_counter()
    xr, it = plain_cg(lmv, b64, tol, CG_ITERS)
    torch.cuda.synchronize()
    plain_solve_s = time.perf_counter() - t
    x64 = u.storage.to(torch.float64)
    check(torch.isfinite(x64).all().item(), "Laplacian CG: x not finite")
    x_rel = (torch.linalg.vector_norm(x64 - xr)
             / torch.linalg.vector_norm(xr)).item()
    res_rel = (torch.linalg.vector_norm(b64 - lmv(x64))
               / torch.linalg.vector_norm(b64)).item()
    check(x_rel <= LAPLACE_X_TOL, f"Laplacian CG x differs by {x_rel}")
    check(res_rel <= 1 / LAPLACE_RESIDUAL_DROP,
          f"Laplacian CG residual fell only to {res_rel} of |b|")
    report("cg_laplacian_f32", {
        "n": RANDOM_N, "nnz": int(lp[-1]), "host_build_s": build_s,
        "slots_over_nnz": D.slots / int(lp[-1]),
        "tail_rows": 0 if D.tail is None else int(D.tail.rows.numel()),
        "iterations": iters, "plain_f64_iterations": it,
        "ms_per_iter": solve_s / iters * 1e3,
        "plain_f64_ms_per_iter": plain_solve_s / it * 1e3,
        "x_rel_err_vs_f64": x_rel, "residual_over_b": res_rel,
        "launches": launches})

    rows = [
        ("expression_assign", "triton", "vexcl_tpu_torch/expr/triton_emit.py",
         "vexcl_tpu/expr/compile.py:244", "expr"),
        ("map_reduce", "triton", "vexcl_tpu_torch/ops/triton_reduce.py",
         "vexcl_tpu/ops/pallas_reduce.py:34", "reduce"),
        ("dia_spmv", "cuda", "vexcl_tpu_torch/csrc/dia_spmv.cu",
         "vexcl_tpu/sparse/pallas_dia.py:51", "dia"),
        ("stencil_1d", "cuda", "vexcl_tpu_torch/csrc/stencil.cu",
         "vexcl_tpu/ops/pallas_stencil.py:59", "stencil"),
        ("sell_spmv", "cuda", "vexcl_tpu_torch/csrc/spmv_sell.cu",
         "vexcl_tpu/sparse/shuffle.py:252", "sell"),
        ("csr_spmv", "cuda", "vexcl_tpu_torch/csrc/spmv_sell.cu",
         "vexcl_tpu/sparse/shuffle.py:807", "csr"),
    ]
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": main_launches[key], "max_abs_err": kernels[key][0],
         "ms": kernels[key][1], "plain_ms": kernels[key][2]}
        for name, route, src, rep, key in rows]}
    results["kernels"] = line["kernels"]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=1)
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
