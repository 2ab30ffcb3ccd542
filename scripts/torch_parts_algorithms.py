#!/usr/bin/env python3
"""Where the time of sort, the FFT, the keyed scans, reduce_by_key and
any_of over four parts of one card goes, beside one part:

    python3 scripts/torch_parts_algorithms.py [DIR]

imports the package from DIR (default: this checkout) and prints one JSON
line.  For each call, at chip_smoke.py phase 18's sizes (2^24 elements;
``sort_by_key`` of i32 keys with f32 values, the 1-D FFT of c64, the 2-D
FFT of 4096^2 c64, ``inclusive_scan_by_key`` and ``reduce_by_key`` of f32
over i32 keys in runs of 63, ``any_of`` of an expression), one part's and
four parts' events ms (``chip_smoke.cuda_ms``, three timings each in
turns), host µs a call (``chip_smoke.host_us``), the device µs of a
four-part call by kernel and the device's busy share
(``chip_smoke.profile_call``), and the host functions that take most of
a four-part call (cProfile over ten calls: each function's own time a
call in µs, the largest first).  cProfile adds its own cost to every
Python call, so its µs read as shares, not as the host's time.
"""

import cProfile
import json
import os
import pstats
import statistics
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 24
SIDE = 4096                   # the 2-D FFT's extents: SIDE^2 == N
PARTS = 4
TOP = 12


def host_profile(fn, calls: int = 10) -> dict:
    """{function: own µs a call} of the largest entries over ``calls``."""
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{os.path.basename(f)}:{line}({name})")
                   for (f, line, name), (_, _, tt, _, _) in stats.items()),
                  reverse=True)[:TOP]
    return {name: tt / calls * 1e6 for tt, name in rows}


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, HERE)
    from chip_smoke import cuda_ms, host_us, profile_call, smi_line

    ctx = vex.Context(vex.Filter.GPU)
    parts = vex.Context(devices=[ctx.device] * PARTS, set_current=False)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, N, dtype=np.int32)
    vals = rng.random(N, dtype=np.float32)
    runs = (np.arange(N) // 63).astype(np.int32)
    sig = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.complex64)

    def calls(c):
        """The timed calls on context c, each on its own inputs."""
        k, v = (vex.vector(data=a, context=c) for a in (keys, vals))
        fk, fv = (vex.vector(data=a, context=c) for a in (keys, vals))
        rk = vex.vector(data=runs, context=c)
        x = vex.vector(data=sig, context=c)
        y = vex.vector(N, dtype=torch.complex64, context=c)
        f1 = vex.FFT(N, dtype=torch.complex64)
        f2 = vex.FFT((SIDE, SIDE), dtype=torch.complex64)

        def sort():
            fk.assign(k)
            fv.assign(v)
            vex.sort_by_key(fk, fv)

        return {"sort_by_key": (sort, 3),
                "fft_2^24": (lambda: y.assign(f1(x)), 10),
                "fft2d_4096": (lambda: y.assign(f2(x)), 10),
                "inclusive_scan_by_key": (
                    lambda: vex.inclusive_scan_by_key(rk, v), 20),
                "reduce_by_key": (lambda: vex.reduce_by_key(rk, v), 20),
                "any_of": (lambda: vex.any_of(v > 2), 20)}

    one, many = calls(ctx), calls(parts)
    row = {"root": root, "card": smi_line()}
    for name, (f1_, reps) in one.items():
        fp = many[name][0]
        got = {"one": [], "parts": []}
        for r in range(3):
            for who in (("one", "parts") if r % 2 == 0 else ("parts", "one")):
                got[who].append(cuda_ms(f1_ if who == "one" else fp, reps))
        device, busy = profile_call(fp, reps)
        row[name] = {
            "ms": {k: statistics.median(v) for k, v in got.items()},
            "ms_range": {k: [min(v), max(v)] for k, v in got.items()},
            "host_us": {"one": host_us(f1_, reps), "parts": host_us(fp, reps)},
            "parts_device_us": device, "parts_busy": busy,
            "parts_host_profile_us": host_profile(fp)}
    print(json.dumps(row))


if __name__ == "__main__":
    main()
