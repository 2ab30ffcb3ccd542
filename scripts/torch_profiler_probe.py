#!/usr/bin/env python3
"""Which device records torch.profiler keeps as a process ages:

    python3 scripts/torch_profiler_probe.py [POINTS] [BUSY_S] [MODES]

At each of POINTS probe points (default 8), BUSY_S seconds apart
(default 30) in which the card runs V2's row sums and an aten add
untraced, traces 100 calls of ``reduce_view_apply`` (row sums of a 4096²
f64 grid) twice in each of MODES (default ``base,spin,tiny``):

* ``base``: the loop alone;
* ``pad``: 20 ms of host idle before the loop and after its sync;
* ``spin``: one 40M-cycle ``torch.cuda._sleep`` kernel first;
* ``tiny``: 200 one-element aten adds first, synchronised.

Prints one JSON line a point: the process's age, and for each trace the
kernel counts by name, the launches and kernels in the exported trace,
the launch-order positions of the launches whose kernel record is
missing, and the least and most µs from a launch to its kernel.
"""

import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import vexcl_tpu_torch as vex  # noqa: E402
from vexcl_tpu_torch.ops.triton_reduce_view import (  # noqa: E402
    prepare_reduce_view, reduce_view_apply)

REPS = 100


def main() -> None:
    points = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    busy_s = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    modes = (sys.argv[3] if len(sys.argv) > 3 else "base,spin,tiny").split(",")
    t0 = time.perf_counter()
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    g = 4096
    x = vex.vector(g * g, dtype=torch.float64, context=ctx)
    x.storage.copy_(torch.rand(g * g, dtype=torch.float64, device=dev))
    args = prepare_reduce_view(
        vex.reduce_view("sum", vex.slicer((g, g))[:, :](x), 1), dev)
    y = torch.zeros(1 << 24, device=dev)
    small = torch.zeros(1, device=dev)

    def rv():
        reduce_view_apply(*args)

    def trace(mode):
        rv()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if mode == "spin":
                torch.cuda._sleep(int(0.02 * 2e9))
            elif mode == "tiny":
                for _ in range(200):
                    small.add_(1)
                torch.cuda.synchronize()
            elif mode == "pad":
                time.sleep(0.02)
            for _ in range(REPS):
                rv()
            torch.cuda.synchronize()
            if mode == "pad":
                time.sleep(0.02)
        counts = {e.key[:40]: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0}
        path = os.path.join(tempfile.gettempdir(), "profiler_probe.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        os.remove(path)
        launch = {e["args"]["correlation"]: e["ts"] for e in evs
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "Launch" in e.get("name", "")
                  and "correlation" in e.get("args", {})}
        kernels = [e for e in evs if e.get("cat") == "kernel"]
        kept = {e["args"].get("correlation") for e in kernels}
        skew = [e["ts"] - launch[e["args"]["correlation"]] for e in kernels
                if e["args"].get("correlation") in launch]
        order = sorted(launch, key=launch.get)
        missing = [i for i, c in enumerate(order) if c not in kept]
        return dict(counts=counts, n_launch=len(order),
                    n_kernel=len(kernels),
                    missing=missing if len(missing) <= 16
                    else missing[:8] + ["..."] + missing[-8:],
                    skew_min_us=min(skew, default=None),
                    skew_max_us=max(skew, default=None))

    for _ in range(points):
        row = dict(age_s=round(time.perf_counter() - t0, 1))
        for mode in modes + modes:
            row.setdefault(mode, []).append(trace(mode))
        print(json.dumps(row), flush=True)
        t = time.perf_counter()
        while time.perf_counter() - t < busy_s:
            for _ in range(50):
                rv()
                y.add_(1)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
