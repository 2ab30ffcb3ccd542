#!/usr/bin/env python3
"""The gather through a permutation, through the public API, for
comparing two versions of ``vexcl_tpu_torch`` in turns on one card and
for setting ``ops/cuda_gather.route``'s thresholds and plan:

    python3 scripts/torch_gather_turns.py DIR [--sweep] [--variants]
                                              [--json FILE]

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line with, for each call at
``chip_smoke.py``'s phase-13 sizes, the host µs a call, the events ms of
back-to-back calls and the profiler's device µs a call of every kernel it
launches, beside ``torch.index_select``: ``y[:] = permutation(p)(x)`` of
2^24 f32 and f64 through a random i32 permutation.  Each result is
checked against ``index_select`` first (bitwise).  Run versions in turns
in one chip call (parent, change, change, parent), one process each.

Where the tree has ``ops/cuda_gather.py``, each dtype also gives
``tree``: ``y[:] = permutation(p)(x) * 2 + 1`` in V1's one pass (the
route does not take a tree around the view) against the view gathered
into a temporary by the form and then ``y[:] = t * 2 + 1``, events ms
each, the results checked equal.

``--variants`` (a tree with ``ops/cuda_gather.py``) times the form alone
on the same calls at other cuts (source range bytes, tile; those the
kernels' shared memory takes): events ms, and the device µs of each
kernel.

``--sweep`` adds the events ms a call with the route forced to V1's
single pass and to the form, and through the API as it routes, over f32,
f64, i32 and i64 sources of 2^14 to 2^28 bytes, 1/16 to 16 destinations
a source element (at most 2^26), i32 and i64 indices, and random and
sorted indices (a permutation's prefix where n is at most the source,
uniform indices otherwise).
"""

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 24
#: (range bytes, tile) of --variants
VARIANTS = [(rb, tile) for rb in (1 << 14, 1 << 15, 1 << 16, 1 << 17)
            for tile in (1 << 13, 1 << 14, 1 << 15)]
SWEEP_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
SWEEP_BYTES_LOG2 = range(14, 29)
SWEEP_PER_ELEMENT = (1 / 16, 1 / 4, 1, 4, 16)
SWEEP_MAX_N = 1 << 26
#: events of a sweep point: about this many ms of calls, 3 to 100 calls
SWEEP_MS = 20.0


def events_ms(fn, ms: float = None, reps: int = 100) -> float:
    """CUDA events around back-to-back calls after a warm one: ``reps``,
    or about ``ms`` worth of them (3 to 100)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ms is not None:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t) * 1e3
        reps = max(3, min(100, int(ms / max(once, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    sys.path.insert(2, HERE)
    from chip_smoke import profile_call, smi_line
    from torch_host_turns import host_us

    try:
        from vexcl_tpu_torch.ops import cuda_gather
    except ImportError:
        cuda_gather = None
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    p = vex.vector._adopt(perm, ctx)
    out = {"card": smi_line(), "root": root}
    for dt in (torch.float32, torch.float64):
        x = vex.vector(data=torch.rand(N, generator=gen, device=dev,
                                       dtype=dt), context=ctx)
        y = vex.vector(N, dtype=dt, context=ctx)

        def call():
            y[:] = vex.permutation(p)(x)

        def lib():
            return torch.index_select(x.storage, 0, perm)
        call()
        bits = torch.int32 if dt == torch.float32 else torch.int64
        assert torch.equal(y.storage.view(bits), lib().view(bits)), dt
        rec = {}
        for tag, f in (("api", call), ("library", lib)):
            per_kernel, _ = profile_call(f, 20)
            rec[tag] = {"host_us": host_us(f), "ms": events_ms(f),
                        "device_us": sum(per_kernel.values()),
                        "kernels": per_kernel}
        if cuda_gather is not None:
            rec["tree"] = tree(vex, ctx, p, x, y)
        if args.variants and cuda_gather is not None:
            rec["variants"] = variants(cuda_gather, y.storage, perm,
                                       x.storage, lib(), profile_call)
        out[f"gather_{str(dt)[6:]}"] = rec
        print(json.dumps({k: v for k, v in rec.items() if k != "variants"}),
              file=sys.stderr)
        del x, y
    if args.sweep and cuda_gather is not None:
        out["sweep"] = sweep(vex, ctx, cuda_gather)
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)


def tree(vex, ctx, p, x, y):
    """{"v1", "two_pass": events ms} of a tree around the view."""
    t = vex.vector(y.size, dtype=y.storage.dtype, context=ctx)

    def v1():
        y[:] = vex.permutation(p)(x) * 2 + 1

    def two_pass():
        t[:] = vex.permutation(p)(x)
        y[:] = t * 2 + 1
    v1()
    want = y.storage.clone()
    two_pass()
    assert torch.equal(y.storage, want)
    return {"v1": events_ms(v1), "two_pass": events_ms(two_pass)}


def variants(cg, y, idx, x, want, profile_call):
    """[{cut, ms, device µs by kernel at the module's tile}] of the form
    alone on (y, idx, x), each result checked bitwise first."""
    bits = torch.int32 if x.element_size() == 4 else torch.int64
    res = []
    for rb, tile in VARIANTS:
        plan = cg.gather_plan(x.numel(), idx.numel(), x.element_size(), rb,
                              tile)
        if not cg._fits(plan, x.element_size()):
            continue

        def call():
            cg._launch(y, idx, x, plan)
        y.zero_()
        call()
        assert torch.equal(y.view(bits), want.view(bits)), plan
        row = {"range_bytes": rb, "tile": tile, "ms": events_ms(call)}
        row["kernels"], _ = profile_call(call, 20)
        row["device_us"] = sum(row["kernels"].values())
        res.append(row)
        print(json.dumps(row), file=sys.stderr)
    return res


def _sweep_index(src_len, n, sort, idt, gen, dev):
    if n <= src_len:
        idx = torch.randperm(src_len, generator=gen, device=dev)[:n]
    else:
        idx = torch.randint(0, src_len, (n,), generator=gen, device=dev)
    if sort:
        idx = idx.sort().values
    return idx.to(idt)


def sweep(vex, ctx, cg):
    """"dtype index 2^lg per order" -> {"v1", "form", "api": events ms a
    call, "routed": the route's choice}."""
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(1)
    routed = cg.route
    res = {}
    try:
        for dt in SWEEP_TYPES:
            size = torch.tensor([], dtype=dt).element_size()
            for lb in SWEEP_BYTES_LOG2:
                src_len = (1 << lb) // size
                x = vex.vector._adopt(
                    torch.randint(-1000, 1000, (src_len,), generator=gen,
                                  device=dev).to(dt), ctx)
                for per in SWEEP_PER_ELEMENT:
                    n = max(1, int(src_len * per))
                    if n > SWEEP_MAX_N:
                        continue
                    y = vex.vector(n, dtype=dt, context=ctx)
                    for idt in (torch.int32, torch.int64):
                        for order in ("random", "sorted"):
                            iv = vex.vector._adopt(_sweep_index(
                                src_len, n, order == "sorted", idt, gen,
                                dev), ctx)

                            def call():
                                y[:] = vex.permutation(iv)(x)
                            rec = {}
                            for form, choice in (("v1", False),
                                                 ("form", True)):
                                cg.route = (lambda *a, _c=choice: _c)
                                rec[form] = events_ms(call, SWEEP_MS)
                            cg.route = routed
                            rec["api"] = events_ms(call, SWEEP_MS)
                            rec["routed"] = routed(dt, src_len, n, idt)
                            per_s = (f"1/{round(1 / per)}" if per < 1
                                     else str(per))
                            res[f"{str(dt)[6:]} {str(idt)[6:]} 2^{lb} "
                                f"{per_s} {order}"] = rec
                            del iv
                    del y
                del x
                torch.cuda.empty_cache()
    finally:
        cg.route = routed
    return res


if __name__ == "__main__":
    main()
