#!/usr/bin/env python3
"""The generated kernels of gathering assignments at other launch shapes:

    python3 scripts/torch_image_shapes.py [--json FILE]

``z[:] = img(X, Y)`` of a 4096^2 f32 ``image2d``, bilinear and nearest,
and ``z[:] = slicer((4096, 4096))[i, j](x)``, each at 2^24 random points
(``chip_smoke.py`` phase 15's workloads).  Each expression's assignment
kernel source (``triton_emit.assign_source``, the source the port
launches) is compiled at every (BLOCK, warps) of ``SHAPES`` and checked
bitwise against the port's own launch of it (``triton_emit.assign``),
then all shapes are timed in turns (``chip_smoke.in_turns``: the median
of ``chip_smoke.TURNS`` timings of 100 launches by CUDA events, with
their range) beside the port's launch (``port``).  BLOCK elements a
program over ``warps`` warps: BLOCK / (32 warps) elements a thread.
Prints the card's name and power limit and one JSON line.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
N = 1 << 24
GRID = 4096
#: (BLOCK, warps): 1, 2, 4, 8 and 16 elements a thread
SHAPES = [(256, 8), (512, 8), (1024, 8), (1024, 4), (2048, 4)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the record to this file")
    args = ap.parse_args()

    import chip_smoke as cs
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch._build import triton_module
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import (assign, assign_source,
                                                  launch_args)

    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    img = torch.rand(GRID, GRID, generator=gen, device=dev)
    X, Y = (vex.vector(data=torch.rand(N, generator=gen, device=dev)
                       * (GRID - 1), context=ctx) for _ in range(2))
    i, j = (vex.vector(data=torch.randint(0, GRID, (N,), generator=gen,
                                          device=dev, dtype=torch.int32),
                       context=ctx) for _ in range(2))
    xg = vex.vector(data=img.view(-1), context=ctx)
    exprs = {
        "image_linear": vex.image2d(img, filter="linear", context=ctx)(X, Y),
        "image_nearest": vex.image2d(img, filter="nearest",
                                     context=ctx)(X, Y),
        "advanced_index": vex.slicer((GRID, GRID))[i, j](xg),
    }
    rec = {"card": cs.smi_line(), "n": N, "shapes": SHAPES}
    print(rec["card"], flush=True)
    for name, expr in exprs.items():
        e, an, ty, lv = prepare(expr, N, dev)
        ref = torch.empty(N, device=dev)
        assign(e, an, ty, lv, ref)
        fn = triton_module(assign_source(e, an, ty, ty[id(e)])).assign_kernel
        kargs = launch_args(lv)
        fns = {"port": lambda e=e, an=an, ty=ty, lv=lv, ref=ref:
               assign(e, an, ty, lv, ref)}
        for block, warps in SHAPES:
            out = torch.empty(N, device=dev)
            grid = (-(-N // block),)

            def launch(out=out, grid=grid, block=block, warps=warps):
                fn[grid](out, *kargs, N, BLOCK=block, num_warps=warps)

            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"{name} at {(block, warps)} differs from "
                                 "the port's launch")
            fns[f"{block}x{warps}"] = launch
        turns = cs.in_turns(fns)
        rec[name] = {k: {"ms": v["ms"], "ms_range": v["ms_range"]}
                     for k, v in turns.items()}
        print(name, json.dumps(rec[name]), flush=True)
    line = json.dumps(rec)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
