#!/usr/bin/env python3
"""Time the port's one-pair map-reduce (``Sum(x*y)``, 2^24 f32) on the
card, for comparing two versions of ``vexcl_tpu_torch`` in turns:

    python3 scripts/torch_map_reduce_turns.py DIR

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line: ``ms`` (CUDA events over
100 back-to-back kernel calls, median of 5), ``host_us`` (host clock per
kernel call without a sync, median of 3 x 200 calls), ``api_us``
(``Reductor(SUM)(x*y)`` with its result on the host, median of 3 x 100)
and ``device_us`` (the profiler's device time per call).  Run versions in
turns in one chip call (parent, change, change, parent): the host's part
varies between processes.
"""

import json
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

N = 1 << 24


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.ops.triton_reduce import map_reduce

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y = (vex.vector(data=torch.rand(N, device=dev, generator=gen),
                       context=ctx) for _ in range(2))
    e, an, ty, lv = prepare(x * y, N, dev)

    def kernel():
        return map_reduce(e, an, ty, lv, N, "SUM", dev)

    def ms(fn, reps=100):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def host_us(fn, calls):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
        return us

    kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            kernel()
        torch.cuda.synchronize()
    device_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.self_device_time_total > 0) / 100
    print(json.dumps({
        "pkg": sys.argv[1], "card": torch.cuda.get_device_name(0),
        "ms": statistics.median(ms(kernel) for _ in range(5)),
        "host_us": statistics.median(host_us(kernel, 200) for _ in range(3)),
        "api_us": statistics.median(host_us(
            lambda: vex.Reductor(vex.SUM)(x * y), 100) for _ in range(3)),
        "device_us": device_us}))


if __name__ == "__main__":
    main()
