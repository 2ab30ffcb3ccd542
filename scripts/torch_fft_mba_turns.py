#!/usr/bin/env python3
"""The FFT API and MBA's interpolant through the API, of the package at
DIR, beside a raw ``torch.fft.fftn``: run a parent and a change in turns
in one call to compare them on one card.

    python3 scripts/torch_fft_mba_turns.py DIR [--json FILE]

For each of ``chip_smoke.FFT_CASES``: ``y[:] = f(x)`` (a prepared
``FFTExpr``) and a raw ``torch.fft.fftn`` into a fresh tensor, in turns
(events ms: the median of ``chip_smoke.TURNS`` timings of 100 calls,
with their range), and the host µs a call of each (200 calls, no sync).
For MBA, the bench's fit at 2^24 f32 points: ``z[:] = interp(X, Y)``
(a prepared expression) by events ms, device µs by kernel (the
profiler), and host µs a call.  Prints one JSON line with the card's
name and power limit; the package is imported from DIR, the timing
helpers from this checkout's ``chip_smoke.py``.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    root = os.path.abspath(args.dir)
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__

    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": cs.smi_line(), "dir": args.dir,
           "package": os.path.dirname(vex.__file__)}
    kinds = {"c64": torch.complex64, "c128": torch.complex128}
    for name, shape, dims, dname in cs.FFT_CASES:
        dt = kinds[dname]
        n = int(np.prod(shape))
        rt = dt.to_real()
        x = vex.vector._adopt(torch.complex(
            torch.rand(n, generator=gen, device=dev, dtype=rt),
            torch.rand(n, generator=gen, device=dev, dtype=rt)), ctx)
        y = vex.vector(n, dtype=dt, context=ctx)
        fx = vex.FFT(shape, dims=dims, dtype=dt)(x)
        xv = x.storage.view(shape)
        fns = {"api": lambda: y.assign(fx),
               "raw": lambda: torch.fft.fftn(xv, dim=dims)}
        turns = cs.in_turns(fns)
        out[name] = {k: {"ms": turns[k]["ms"], "ms_range": turns[k]["ms_range"],
                         "host_us": cs.host_us(f)} for k, f in fns.items()}
        out[name]["api_over_raw"] = turns["api"]["ms"] / turns["raw"]["ms"]
        del x, y, fx, xv, fns
        torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    sx, sy = rng.random(4096), rng.random(4096)
    surf = vex.mba(lo=(-0.01, -0.01), hi=(1.01, 1.01), coords=(sx, sy),
                   values=np.sin(7 * sx) * np.cos(5 * sy), grid=(8, 8),
                   levels=6, context=ctx)
    n = 1 << 24
    X, Y = (vex.vector._adopt(torch.rand(n, generator=gen, device=dev), ctx)
            for _ in range(2))
    z = vex.vector(n, context=ctx)
    expr = surf(X, Y)
    call = lambda: z.assign(expr)  # noqa: E731
    turns = cs.in_turns({"mba": call})
    per_kernel, _ = cs.profile_call(call, cs.KERNEL_REPS)
    out["mba_2^24_f32"] = {"ms": turns["mba"]["ms"],
                           "ms_range": turns["mba"]["ms_range"],
                           "device_us": sum(per_kernel.values()),
                           "kernels": {k: round(v, 3)
                                       for k, v in per_kernel.items()},
                           "host_us": cs.host_us(call, 20)}
    line = json.dumps(out)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
