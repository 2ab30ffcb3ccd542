#!/usr/bin/env python3
"""MBA's tap sum on the card: the CUDA kernel beside V1's tree, and the
two forms of an interpolant inside a larger tree:

    python3 scripts/torch_mba_variants.py [--json FILE]

The bench's fit (``chip_smoke.py`` phase 14: 4096 samples of sin(7x)
cos(5y), grid 8 x 8, 6 levels, a 259^2 lattice) at 2^24 random points, in
f32 and f64:

* ``kernel``: ``cuda_mba.mba_eval`` through the type's table
  (``cuda_mba.table``; ``csrc/mba.cu``), checked against the plain
  version first (f32 1e-5, f64 1e-12 of the largest magnitude);
* ``v1_tree``: the interpolant's elementwise tree in V1's generated
  kernel (the route before the kernel; its prepared launch);
* ``in_tree_kernel`` and ``in_tree_fused``: ``z[:] = 2 * interp(X, Y) +
  W`` through the API with the interpolant run by the kernel into a
  temporary (the node hoisted), and as V1's one fused tree;
* ``api``: ``z[:] = interp(X, Y)`` through the API (one launch of the
  kernel), with its host µs a call.

Events ms: the median of ``chip_smoke.TURNS`` timings of 100 calls, all
forms in turns, with their range; device µs a call by the profiler
(``chip_smoke.profile_call``); the card's name and power limit.  Prints
one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
N = 1 << 24
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import assign
    from vexcl_tpu_torch.ops import cuda_mba
    from vexcl_tpu_torch.ops.mba import mba_device_eval

    n = args.n
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(7)
    sx, sy = rng.random(4096), rng.random(4096)
    surf = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                   values=np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8),
                   levels=6, context=ctx)
    out = {"card": cs.smi_line(), "n": n,
           "lattice": list(surf.lattice.shape)}
    for dt in (torch.float32, torch.float64):
        X, Y, W = (vex.vector._adopt(torch.rand(n, generator=gen, device=dev,
                                                dtype=dt), ctx)
                   for _ in range(3))
        z = vex.vector(n, dtype=dt, context=ctx)
        lat = surf.tables(dt, dev)[0]
        want = torch.empty(n, dtype=dt, device=dev)
        cuda_mba.mba_plain(want, [X.storage, Y.storage], lat, surf.lo,
                           surf.hi, surf.grids[0])
        scale = want.abs().max().item()
        tab = surf.kernel_table(dt, dev)
        k = torch.empty_like(want)
        fns = {"kernel": lambda k=k, tab=tab: cuda_mba.mba_eval(
            k, [X.storage, Y.storage], lat, surf.lo, surf.hi,
            surf.grids[0], tab)}
        fns["kernel"]()
        torch.cuda.synchronize()
        err = (k - want).abs().max().item() / scale
        if err > TOL[dt]:
            raise SystemExit(f"kernel {dt}: error {err}")
        res = {"kernel": {"max_rel_err": err,
                          "table_bytes": tab.numel() * tab.element_size()}}
        # V1's tree (its prepared launch), and the API's call
        shape = tuple(g + 3 for g in surf.grids[0])
        tree = mba_device_eval(surf.lo, surf.hi, surf.grids,
                               [lat.reshape(shape)], [X, Y])
        e, an, ty, lv = prepare(tree, n, dev)
        kt = torch.empty_like(want)
        assign(e, an, ty, lv, kt)
        fns["v1_tree"] = lambda: assign(e, an, ty, lv, kt)
        api = surf(X, Y)
        fns["api"] = lambda: z.assign(api)
        # inside a larger tree: the node hoisted, or V1's fused tree
        big_k = 2 * surf(X, Y) + W
        big_f = 2 * tree + W
        fns["in_tree_kernel"] = lambda: z.assign(big_k)
        fns["in_tree_fused"] = lambda: z.assign(big_f)
        for name in ("v1_tree", "in_tree_kernel", "in_tree_fused"):
            fns[name]()
        z.assign(big_k)
        a = z.storage.clone()
        z.assign(big_f)
        torch.cuda.synchronize()
        res["in_tree_max_abs_diff"] = (a - z.storage).abs().max().item()
        turns = cs.in_turns(fns)
        for name, fn in fns.items():
            per_kernel, _ = cs.profile_call(fn, cs.KERNEL_REPS)
            res.setdefault(name, {}).update(
                ms=turns[name]["ms"], ms_range=turns[name]["ms_range"],
                device_us=sum(per_kernel.values()),
                kernels={k_: round(v, 3) for k_, v in per_kernel.items()})
        res["api"]["host_us"] = cs.host_us(fns["api"])
        res["v1_tree"]["api_host_us"] = cs.host_us(lambda: z.assign(tree),
                                                   20)
        res["bound_ms"] = cs.bound(3 * n * dt.itemsize)[0]
        out[str(dt).replace("torch.", "")] = res
        del X, Y, W, z, want, k, kt, e, lv, api, big_k, big_f, tree
        torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
