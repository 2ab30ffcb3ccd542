#!/usr/bin/env python3
"""Time the port's view kernels (V1, V2) on the card at the 4096^2 grid,
for comparing two versions of ``vexcl_tpu_torch`` in turns, or one
version with other tile constants:

    python3 scripts/torch_view_turns.py DIR [--set MODULE.NAME=VALUE ...]

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there), sets each ``--set`` constant (``MODULE`` one of
``triton_emit``, ``triton_reduce_view``; ``VALUE`` a Python literal)
and prints one JSON line: for each workload, ``us`` (the profiler's
device time per kernel call, over 100 calls), ``library_us`` (the same
for its PyTorch call) and ``bound_us`` (its bytes, each input read and
each output written once, over 3.35 TB/s), and the card's name and
power limit.  Every kernel result is checked against its plain version
first: bitwise for moves, min and max (values, NaN where a NaN is),
within 1e-5 (f32) / 1e-12 (f64) for sums.  Run versions in turns in one
chip call (parent, change, change, parent).
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

G = 4096
N = G * G
DIMS3 = (512, 256, 128)
HBM_BYTES_S = 3.35e12


def device_us(fn, reps=100):
    """Device time per call (µs) of every kernel fn launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.expr import triton_emit
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.ops import triton_reduce_view

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    mods = {"triton_emit": triton_emit,
            "triton_reduce_view": triton_reduce_view}
    sets = {}
    args = sys.argv[2:]
    for i, a in enumerate(args):
        if a == "--set":
            name, value = args[i + 1].split("=", 1)
            mod, attr = name.split(".")
            setattr(mods[mod], attr, ast.literal_eval(value))
            sets[name] = value
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    slc = vex.slicer((G, G))
    rows = {}

    def rand(n, dt):
        return vex.vector(data=torch.rand(n, generator=gen, device=dev,
                                          dtype=dt), context=ctx)

    def same(a, b):
        nan = torch.isnan(b)
        return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan],
                                                                b[~nan])

    def row(name, fn, library, nbytes):
        rows[name] = {"us": device_us(fn), "library_us": device_us(library),
                      "bound_us": nbytes / HBM_BYTES_S * 1e6}

    def v1(name, expr, dt, library, nbytes):
        n = expr.size_hint()
        e, an, ty, lv = prepare(expr, n, dev)
        k = torch.empty(n, dtype=dt, device=dev)
        p = torch.empty_like(k)
        triton_emit.assign(e, an, ty, lv, k)
        triton_emit.assign_plain(e, an, ty, lv, p)
        assert torch.equal(k, p), name
        row(name, lambda: triton_emit.assign(e, an, ty, lv, k), library,
            nbytes)

    def v2(name, node, library, nbytes, exact):
        a = triton_reduce_view.prepare_reduce_view(node, dev)
        triton_reduce_view.reduce_view_apply(*a)
        p = torch.empty_like(a[-1])
        triton_reduce_view.reduce_view_plain(*a[:-1], p)
        if exact:
            assert same(a[-1], p), name
        else:
            rel = ((a[-1].double() - p.double()).abs().max()
                   / p.double().abs().max()).item()
            assert rel <= (1e-5 if p.dtype == torch.float32 else 1e-12), name
        row(name, lambda: triton_reduce_view.reduce_view_apply(*a), library,
            nbytes)

    for dname, dt in (("f32", torch.float32), ("f64", torch.float64)):
        x = rand(N, dt)
        xv = x.storage.view(G, G)
        es = x.storage.element_size()
        i = G - 2
        v1(f"interior_{dname}", 2 * slc[vex.r(1, G - 1), vex.r(1, G - 1)](x),
           dt, lambda: torch.mul(xv[1:-1, 1:-1], 2), 2 * i * i * es)
        v1(f"transpose_{dname}", vex.reshape(x, (G, G), (1, 0)), dt,
           lambda: xv.t().contiguous(), 2 * N * es)
        v2(f"rowsum_{dname}", vex.reduce_view("sum", slc[:, :](x), 1),
           lambda: xv.sum(1), (N + G) * es, False)
        v2(f"colsum_{dname}", vex.reduce_view("sum", slc[:, :](x), 0),
           lambda: xv.sum(0), (N + G) * es, False)
        xv[5, 7] = float("nan")
        v2(f"colmax_{dname}", vex.reduce_view("max", slc[:, :](x), 0),
           lambda: xv.amax(0), (N + G) * es, True)
        del x, xv
    x = rand(N, torch.float32)
    d0, d1, d2 = DIMS3
    x3 = x.storage.view(d2, d0, d1)
    v1("reshape3d_201_f32", vex.reshape(x, DIMS3, (2, 0, 1)), torch.float32,
       lambda: x3.permute(1, 2, 0).contiguous(), 2 * 4 * N)
    x3 = x.storage.view(d0, d2, d1)
    v1("reshape3d_021_f32", vex.reshape(x, DIMS3, (0, 2, 1)), torch.float32,
       lambda: x3.permute(0, 2, 1).contiguous(), 2 * 4 * N)
    e3 = 256
    m = vex.multi_array(vex.extents[e3][e3][e3], dtype=np.float64,
                        context=ctx, data=torch.rand(
                            e3 ** 3, generator=gen, device=dev,
                            dtype=torch.float64))
    mv = m.vec().storage.view(e3, e3, e3)
    v2("multi_array_sum2_f64", vex.reduce_view("sum", m, 2),
       lambda: mv.sum(2), (e3 ** 3 + e3 * e3) * 8, False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "set": sets, "card": card,
                      "rows": rows}))


if __name__ == "__main__":
    main()
