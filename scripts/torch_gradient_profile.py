#!/usr/bin/env python3
"""Where the host time of a gradient through ``Kernel.as_function()``
goes, on one card:

    python3 scripts/torch_gradient_profile.py OUT

``LorenzEnsemble(2^22)`` in f32, as ``chip_smoke.py`` builds it, and
``gradient()``: ``torch.autograd.grad`` of sum(x_T + y_T + z_T) through 4
steps of ``ens._step.as_function()`` in x0, y0, z0 and R (a forward and a
backward call a step).  Prints one JSON line, each time the median of 20
calls after a warm-up, in ms a gradient:

* ``gradient_ms``: the host clock around ``gradient()``, synchronised;
  ``enqueue_ms``: the same without the synchronisation (the host's own
  time, where it is not waiting on the card);
* ``forward_ms``: the 4 forward calls and the loss, synchronised;
  ``grad_ms``: ``torch.autograd.grad`` alone on such a graph;
* ``inside``: host ms a gradient inside the port's code, by timers wrapped
  around it (they time the autograd engine's device thread too, where the
  backward runs): the forward calls (``as_function``'s ``fn``), the
  backward nodes (``_KernelFunction.backward``), and in both the kernel
  launches (``TritonLauncher.__call__``);
* ``device_us``: the profiler's device µs of one gradient, by kernel;
* ``records_made``: calls of ``Kernel._record`` and of the generator's
  ``prepare_multi`` over 5 gradients after the first (0: every call
  found its record).

Writes the profiler's CPU table (every thread) and cProfile's view of
the calling thread to the file OUT.
"""

import cProfile
import collections
import io
import json
import os
import pstats
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
STEPS = 4
REPS = 20


def median_ms(fn, sync=True, setup=None):
    times = []
    for _ in range(REPS + 1):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(arg) if setup else fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times[1:])


def main() -> None:
    out_path = os.path.abspath(sys.argv[1])
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch import _build, generator
    from vexcl_tpu_torch.models import LorenzEnsemble

    ctx = vex.Context(vex.Filter.GPU)
    ens = LorenzEnsemble(1 << 22, dtype=np.float32, context=ctx)
    fn = ens._step.as_function()
    ins = [v.storage.clone().requires_grad_()
           for v in (ens.x, ens.y, ens.z, ens.R)]

    def forward(f=fn):
        x, y, z, R = ins
        for _ in range(STEPS):
            x, y, z = f(x, y, z, R)
        return (x + y + z).sum()

    def gradient(f=fn):
        return torch.autograd.grad(forward(f), ins)

    for _ in range(3):
        gradient()
    out = {"card": torch.cuda.get_device_name(0)}

    # record misses after the first gradient
    made = collections.Counter()

    def counting(name, f):
        def call(*args, **kwargs):
            made[name] += 1
            return f(*args, **kwargs)
        return call

    record, prepare_multi = generator.Kernel._record, generator.prepare_multi
    generator.Kernel._record = counting("_record", record)
    generator.prepare_multi = counting("prepare_multi", prepare_multi)
    for _ in range(5):
        gradient()
    generator.Kernel._record, generator.prepare_multi = record, prepare_multi
    out["records_made"] = dict(made)

    out["gradient_ms"] = median_ms(gradient)
    out["enqueue_ms"] = median_ms(gradient, sync=False)
    out["forward_ms"] = median_ms(forward)
    out["grad_ms"] = median_ms(lambda loss: torch.autograd.grad(loss, ins),
                               setup=forward)

    # timers around the port's code, on whichever thread runs it
    spent = collections.Counter()

    def timing(name, f):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    kf = generator._KernelFunction
    backward, launch = kf.backward, _build.TritonLauncher.__call__
    kf.backward = staticmethod(timing("backward_nodes", backward))
    _build.TritonLauncher.__call__ = timing("launches", launch)
    timed_fn = timing("forward_calls", fn)
    for _ in range(REPS):
        gradient(timed_fn)
        torch.cuda.synchronize()
    kf.backward, _build.TritonLauncher.__call__ = (staticmethod(backward),
                                                   launch)
    out["inside"] = {k: v * 1e3 / REPS for k, v in spent.items()}

    from chip_smoke import profile_call
    per_kernel, _ = profile_call(gradient, REPS)
    out["device_us"] = per_kernel
    out["device_us_total"] = sum(per_kernel.values())

    text = io.StringIO()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            gradient()
        torch.cuda.synchronize()
    text.write("torch.profiler, %d gradients, by self CPU time\n" % REPS)
    text.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                         row_limit=40))
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(REPS):
        gradient()
    torch.cuda.synchronize()
    pr.disable()
    text.write("\ncProfile, %d gradients, the calling thread\n" % REPS)
    for key in ("tottime", "cumtime"):
        pstats.Stats(pr, stream=text).sort_stats(key).print_stats(30)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(text.getvalue())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
