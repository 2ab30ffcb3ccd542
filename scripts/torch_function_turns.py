#!/usr/bin/env python3
"""The functional form of a recorded kernel (``Kernel.as_function()``)
and its backward, for comparing two versions of ``vexcl_tpu_torch`` in
turns on one card:

    python3 scripts/torch_function_turns.py DIR

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line for
``LorenzEnsemble(2^22)`` in f32, ``chip_smoke.py``'s ensemble:

* ``forward``: ``fn(x, y, z, R)`` of ``ens._step.as_function()`` with no
  input needing a gradient (one launch of the k-output kernel): host µs
  a call, events ms and device µs, as ``torch_host_turns.py`` takes them;
* ``backward``, where the package has one: one step's backward call
  (``Kernel.backward_kernel``'s ``as_function`` on the step's inputs and
  three cotangents of their own), the same three;
* ``gradient_step_ms``, where the package differentiates: the host clock
  around ``torch.autograd.grad`` of sum(x_T + y_T + z_T) through 4 steps
  in x0, y0, z0 and R, synchronised, over 4 (a forward and a backward
  call a step), the median of 20.

Run versions in turns in one chip call (parent, change, change, parent),
one process each.
"""

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from torch_host_turns import device_us, events_ms, host_us

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.models import LorenzEnsemble

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, HERE)
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    ens = LorenzEnsemble(1 << 22, dtype=np.float32, context=ctx)
    fn = ens._step.as_function()
    state = [v.storage.clone() for v in (ens.x, ens.y, ens.z, ens.R)]
    out = {"forward": {"host_us": host_us(lambda: fn(*state)),
                       "ms": events_ms(lambda: fn(*state)),
                       "device_us": device_us(lambda: fn(*state))}}
    if hasattr(ens._step, "backward_kernel"):
        gen = torch.Generator(device=dev).manual_seed(0)
        cots = [torch.rand(1 << 22, generator=gen, device=dev)
                for _ in range(3)]
        bk = ens._step.backward_kernel(state, cots, [True] * 4)
        bkf = bk.as_function()
        out["backward"] = {"host_us": host_us(lambda: bkf(*state, *cots)),
                           "ms": events_ms(lambda: bkf(*state, *cots)),
                           "device_us": device_us(
                               lambda: bkf(*state, *cots))}
        ins = [t.clone().requires_grad_() for t in state]

        def gradient():
            x, y, z, R = ins
            for _ in range(STEPS):
                x, y, z = fn(x, y, z, R)
            return torch.autograd.grad((x + y + z).sum(), ins)

        times = []
        for _ in range(21):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gradient()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) / STEPS * 1e3)
        out["gradient_step_ms"] = statistics.median(times[1:])
    print(json.dumps({"root": root, "card": torch.cuda.get_device_name(0),
                      **out}))


if __name__ == "__main__":
    main()
