#!/usr/bin/env python3
"""The host cost of a call of the port's generated Triton kernels, for
comparing two versions of ``vexcl_tpu_torch`` in turns on one card:

    python3 scripts/torch_host_turns.py DIR

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line, for each workload at
``chip_smoke.py``'s sizes:

* ``host_us``: host µs a call, the median over 20 batches of 100 calls
  of each batch's mean, no synchronisation inside a batch and one
  between batches, off the clock (so no launch waits for room in the
  launch queue);
* ``ms``: CUDA events around 100 back-to-back calls, after a warm call:
  the larger of the device's and the host's time a call;
* ``device_us``: the profiler's device time a call of every kernel the
  call launches, over 100 calls (it must not move between versions);
* the same three for the workload's PyTorch call, where there is one.

The workloads: V2's row sums of a 4096^2 f32 grid (``reduce_view_apply``
on prepared arguments; ``sum(1)``), K2's MIN_MAX of 2^24 f32
(``map_reduce_multi``; ``torch.aminmax``), the map-reduce ``Sum(p*Ap)``
at 256^3 f32 (``map_reduce``; ``torch.dot``), the assignment ``x[:] = r +
0.7*p`` at 2^24 f32 through the API (``torch.add(r, p, alpha=0.7,
out=x)``), ``LorenzEnsemble(2^22).step()`` in f32 and f64 against the
hand-written CUDA RK4 step of ``chip_smoke.py`` (``overhead``: step ms
over raw ms, the reference's ``lorenz_overhead_vs_raw_cuda``), and CG (a),
``PoissonSolver(256).solve(f, maxiter=100)`` in f32 (``ms_per_iter``,
host clock around a synchronised solve, after a 3-iteration one).
Every kernel result is checked against its plain version first.  Run
versions in turns in one chip call (parent, change, change, parent), one
process each.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, BATCHES, REPS = 100, 20, 100


def host_us(fn):
    fn()
    per_batch = []
    for _ in range(BATCHES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(BATCH):
            fn()
        per_batch.append((time.perf_counter() - t) / BATCH * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_batch)


def events_ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def device_us(fn):
    """The profiler's device µs a call of every kernel fn launches, over
    REPS calls, by ``chip_smoke.profile_call`` (which keeps the records
    the profiler drops at a trace's start out of the loop)."""
    from chip_smoke import profile_call
    return sum(profile_call(fn, REPS)[0].values())


def timed(fn, library=None):
    row = {"host_us": host_us(fn), "ms": events_ms(fn),
           "device_us": device_us(fn)}
    if library is not None:
        row.update(library_host_us=host_us(library),
                   library_ms=events_ms(library),
                   library_device_us=device_us(library))
    return row


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.expr.compile import prepare, prepare_multi
    from vexcl_tpu_torch.expr.triton_emit import assign_multi_plain
    from vexcl_tpu_torch.models import LorenzEnsemble, PoissonSolver
    from vexcl_tpu_torch.ops.triton_reduce import (map_reduce,
                                                   map_reduce_multi,
                                                   map_reduce_multi_plain,
                                                   map_reduce_plain)
    from vexcl_tpu_torch.ops.triton_reduce_view import (prepare_reduce_view,
                                                        reduce_view_apply,
                                                        reduce_view_plain)

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, HERE)
    from chip_smoke import RAW_LORENZ

    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(n, dt=torch.float32):
        return vex.vector(data=torch.rand(n, generator=gen, device=dev,
                                          dtype=dt), context=ctx)

    rows = {}
    # V2: row sums of the 4096^2 grid
    g = 4096
    x = rand(g * g)
    a = prepare_reduce_view(
        vex.reduce_view("sum", vex.slicer((g, g))[:, :](x), 1), dev)
    reduce_view_apply(*a)
    p = torch.empty_like(a[-1])
    reduce_view_plain(*a[:-1], p)
    assert (a[-1] - p).abs().max().item() <= 1e-5 * p.abs().max().item()
    xv = x.storage.view(g, g)
    rows["reduce_view_rowsum_f32"] = timed(lambda: reduce_view_apply(*a),
                                           lambda: xv.sum(1))
    del x, xv, a, p
    # K2: MIN_MAX of 2^24 f32
    n = 1 << 24
    u = rand(n)
    e, an, ty, lv = prepare_multi([u], n, dev)
    pairs = [(e[0], "MIN"), (e[0], "MAX")]
    got = map_reduce_multi(pairs, an, ty, lv, n, dev)
    want = map_reduce_multi_plain(pairs, an, ty, lv, n, dev)
    assert [r.item() for r in got] == [r.item() for r in want]
    uh = u.storage
    rows["map_reduce_multi_min_max_f32"] = timed(
        lambda: map_reduce_multi(pairs, an, ty, lv, n, dev),
        lambda: torch.aminmax(uh))
    del u, uh, e, lv, pairs
    # the map-reduce Sum(p * Ap) at 256^3 f32
    m = 256 ** 3
    pv, apv = rand(m), rand(m)
    pap = prepare(pv * apv, m, dev)
    k = map_reduce(*pap, m, "SUM", dev).item()
    ref = map_reduce_plain(*pap, m, "SUM", dev).item()
    assert abs(k - ref) <= 1e-5 * abs(ref)
    rows["map_reduce_sum_pAp_f32"] = timed(
        lambda: map_reduce(*pap, m, "SUM", dev),
        lambda: torch.dot(pv.storage, apv.storage))
    del pv, apv, pap
    # the assignment x[:] = r + 0.7 * p through the API, 2^24 f32
    xa, r, pa = rand(n), rand(n), rand(n)

    def api():
        xa[:] = r + 0.7 * pa
    api()
    want = r.storage + 0.7 * pa.storage
    assert (xa.storage - want).abs().max().item() <= 1e-6
    rows["assign_r_plus_07p_f32"] = timed(
        api, lambda: torch.add(r.storage, pa.storage, alpha=0.7,
                               out=xa.storage))
    del xa, r, pa, want
    # the Lorenz RK4 step, 2^22, f32 and f64, against raw CUDA
    for dname, npdt in (("f32", np.float32), ("f64", np.float64)):
        ens = LorenzEnsemble(1 << 22, dtype=npdt, context=ctx, seed=0)
        ref = LorenzEnsemble.from_arrays(*(v.storage.clone() for v in (
            ens.x, ens.y, ens.z, ens.R)), context=ctx)
        ens.step()
        assign_multi_plain(*ref._step.prepare(ref.x, ref.y, ref.z, ref.R))
        for v, w in zip((ens.x, ens.y, ens.z), (ref.x, ref.y, ref.z)):
            err = ((v.storage - w.storage).abs().max()
                   / w.storage.abs().max()).item()
            assert err <= (1e-5 if npdt == np.float32 else 1e-12), err
        raw = vex.CustomKernel(RAW_LORENZ, name=f"lorenz_{dname}")
        rx, ry, rz, rR = (vex.vector(data=v.storage.clone(), context=ctx)
                          for v in (ens.x, ens.y, ens.z, ens.R))
        row = timed(ens.step)
        row.update(raw_ms=events_ms(lambda: raw(rx, ry, rz, rR)),
                   raw_device_us=device_us(lambda: raw(rx, ry, rz, rR)))
        row["overhead"] = row["ms"] / row["raw_ms"]
        rows[f"lorenz_step_{dname}"] = row
        del ens, ref, raw, rx, ry, rz, rR
        torch.cuda.empty_cache()
    # CG (a): the Poisson 256^3 solve in f32, 100 iterations
    solver = PoissonSolver(256, context=ctx)
    f = (np.random.default_rng(0).random(256 ** 3) - 0.5).astype(np.float32)
    solver.solve(f, maxiter=3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, iters = solver.solve(f, maxiter=100)
    torch.cuda.synchronize()
    rows["cg_poisson256_f32"] = {
        "ms_per_iter": (time.perf_counter() - t) / iters * 1e3,
        "iterations": iters}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    import triton
    print(json.dumps({"root": root, "card": card,
                      "triton": triton.__version__, "rows": rows}))


if __name__ == "__main__":
    main()
