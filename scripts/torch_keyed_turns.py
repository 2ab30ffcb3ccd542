#!/usr/bin/env python3
"""The keyed primitives' calls through the public API, for comparing two
versions of ``vexcl_tpu_torch`` in turns on one card:

    python3 scripts/torch_keyed_turns.py DIR

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line with, for each call at
``chip_smoke.py``'s phase-9 sizes (2^24 f32 values, i32 keys in runs of
64), the host µs a call, the events ms of 100 back-to-back calls and the
profiler's device µs a call of every kernel it launches, with the kernels
by name (the helpers of ``scripts/torch_host_turns.py``):
``inclusive_scan_by_key``, ``exclusive_scan_by_key`` with ``init``,
``reduce_by_key`` (its count's copy to the host included), and
``reduce_by_key`` over the (i32, i64) tuple of the same runs.  Each
result is checked against an f64 reference first.  Run versions in turns
in one chip call (parent, change, change, parent), one process each.
"""

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, RUN = 1 << 24, 64


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    sys.path.insert(2, HERE)
    from chip_smoke import profile_call
    from torch_host_turns import events_ms, host_us

    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    kt = torch.arange(N, device=dev, dtype=torch.int32) // RUN
    keys = vex.vector(data=kt, context=ctx)
    wide = vex.vector(data=kt.long() * 3, context=ctx)
    x = vex.vector(data=torch.rand(N, generator=gen, device=dev),
                   context=ctx)
    y = vex.vector(N, context=ctx)
    sums = x.storage.double().view(-1, RUN).sum(1)
    incl = x.storage.double().view(-1, RUN).cumsum(1).view(-1)

    def close(a, b):
        err = (a.double() - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item(), err

    calls = {
        "inclusive_scan_by_key": lambda: vex.inclusive_scan_by_key(keys, x, y),
        "exclusive_scan_by_key_init": lambda: vex.exclusive_scan_by_key(
            keys, x, y, init=1.0),
        "reduce_by_key": lambda: vex.reduce_by_key(keys, x),
        "reduce_by_key_tuple": lambda: vex.reduce_by_key((keys, wide), x)}
    calls["inclusive_scan_by_key"]()
    close(y.storage, incl)
    calls["exclusive_scan_by_key_init"]()
    excl = 1.0 + torch.cat([incl.new_zeros(1), incl[:-1]])
    excl.view(-1, RUN)[:, 0] = 1.0           # init at each head
    close(y.storage, excl)
    for name in ("reduce_by_key", "reduce_by_key_tuple"):
        okeys, ovals, m = calls[name]()
        assert m == N // RUN
        close(ovals.storage, sums)
    out = {"card": torch.cuda.get_device_name(0), "root": root}
    for name, fn in calls.items():
        per_kernel, _ = profile_call(fn, 100)
        out[name] = {"host_us": host_us(fn), "ms": events_ms(fn),
                     "device_us": sum(per_kernel.values()),
                     "kernels": per_kernel}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
