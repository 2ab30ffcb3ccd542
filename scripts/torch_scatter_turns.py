#!/usr/bin/env python3
"""Assignment through a permutation, through the public API, for
comparing two versions of ``vexcl_tpu_torch`` in turns on one card and
for setting ``ops/cuda_scatter.route``'s thresholds:

    python3 scripts/torch_scatter_turns.py DIR [--sweep] [--json FILE]

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line with, for each call at
``chip_smoke.py``'s phase-13 sizes, the host µs a call, the events ms of
back-to-back calls and the profiler's device µs a call of every kernel it
launches, beside its PyTorch call: the scatter of 2^24 f32 through a
permutation (``index_copy_``), the histogram of 2^24 i32 keys into 2^16
i32 bins (``bincount``) and the f32 atomic add of 2^24 values into 2^16
bins (``index_add_``).  Each result is checked against its PyTorch call
first (bitwise, exact, 1e-5 relative).

``--sweep`` adds the events ms a call through a permutation of ``=``,
``atomic_add``, ``atomic_min`` and ``atomic_max`` into f32, f64, i32 and
i64 targets, and of the histogram (``atomic_add`` of 1 into i32 and i64
bins), at targets of 2^14 to 2^28 bytes and 1, 1/4, 1/16 and 1/256
updates a target element (unique indices for ``=``, uniform ones
otherwise; where form B takes the target, also 16 and 256): through the
API as it routes, and, where the tree has ``ops/cuda_scatter.py``, with
the route forced to each form (V3's Triton kernel; form A from 4 MB
targets; form B up to eight windows).  Run versions in turns in one chip
call (parent, change, change, parent), one process each.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BINS = 1 << 24, 1 << 16
#: the sweep's (mode, target type) cells; "histogram" is the add of 1
SWEEP_CELLS = [(m, t) for m in ("store", "add", "min", "max")
               for t in (torch.float32, torch.float64, torch.int32,
                         torch.int64)] + [("histogram", torch.int32),
                                          ("histogram", torch.int64)]
#: target bytes 2^14 to 2^28
SWEEP_BYTES_LOG2 = range(14, 29)
#: updates a target element: 1, 1/4, 1/16, 1/256; and, where form B takes
#: the target (at most SWEEP_WINDOWS windows), 16 and 256
SWEEP_PER_ELEMENT = (1, 1 / 4, 1 / 16, 1 / 256)
SWEEP_DENSE = (16, 256)
SWEEP_WINDOWS = 8
#: form A is timed from targets of this many bytes
SWEEP_RANGES_MIN_BYTES = 1 << 22


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    sys.path.insert(1, os.path.join(HERE, "scripts"))
    sys.path.insert(2, HERE)
    from chip_smoke import profile_call, smi_line
    from torch_host_turns import events_ms, host_us

    try:
        from vexcl_tpu_torch.ops import cuda_scatter
    except ImportError:
        cuda_scatter = None
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    p = vex.vector._adopt(perm, ctx)
    x = vex.vector(data=torch.rand(N, generator=gen, device=dev),
                   context=ctx)
    y = vex.vector(N, context=ctx)
    keys = torch.randint(0, BINS, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    k = vex.vector._adopt(keys, ctx)
    hist = vex.vector(BINS, dtype=torch.int32, context=ctx)
    hf = vex.vector(BINS, context=ctx)
    lib = torch.zeros(N, device=dev)
    perm64 = perm.long()

    calls = {
        "scatter_f32": (lambda: vex.permutation(p)(y).assign(x),
                        lambda: lib.index_copy_(0, perm64, x.storage)),
        "histogram_i32": (lambda: vex.eval(vex.atomic_add(
            vex.permutation(k)(hist), 1)),
            lambda: torch.bincount(keys, minlength=BINS)),
        "atomic_add_f32": (lambda: vex.eval(vex.atomic_add(
            vex.permutation(k)(hf), x)),
            lambda: torch.zeros(BINS, device=dev).index_add_(
                0, keys.long(), x.storage)),
    }
    calls["scatter_f32"][0]()
    calls["scatter_f32"][1]()
    assert torch.equal(y.storage.view(torch.int32), lib.view(torch.int32))
    hist.storage.zero_()
    calls["histogram_i32"][0]()
    assert torch.equal(hist.storage.long(), calls["histogram_i32"][1]())
    hf.storage.zero_()
    calls["atomic_add_f32"][0]()
    want = calls["atomic_add_f32"][1]()
    err = (hf.storage.double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    out = {"card": smi_line(), "root": root}
    for name, (fn, libfn) in calls.items():
        rec = {}
        for tag, f in (("api", fn), ("library", libfn)):
            per_kernel, _ = profile_call(f, 20)
            rec[tag] = {"host_us": host_us(f), "ms": events_ms(f),
                        "device_us": sum(per_kernel.values()),
                        "kernels": per_kernel}
        out[name] = rec
    if args.sweep:
        out["sweep"] = sweep(vex, ctx, cuda_scatter, events_ms)
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)


def _sweep_data(mode, dtype, target, n, gen, dev):
    """(index, values or None) of one sweep point: unique indices for
    ``=``, uniform ones otherwise; values uniform in [0, 1) or normal for
    floats, in [-1000, 1000) for integers; None for the histogram."""
    if mode == "store":
        idx = torch.randperm(target, generator=gen, device=dev)[:n]
    else:
        idx = torch.randint(0, target, (n,), generator=gen, device=dev)
    idx = idx.to(torch.int32)
    if mode == "histogram":
        return idx, None
    if dtype.is_floating_point:
        val = (torch.randn if mode in ("min", "max") else torch.rand)(
            n, generator=gen, device=dev, dtype=dtype)
    else:
        val = torch.randint(-1000, 1000, (n,), generator=gen, device=dev,
                            dtype=dtype)
    return idx, val


def _sweep_forms(cuda_scatter, mode, dtype, target, n):
    """The forms a sweep point forces: V3's Triton kernel; form A from
    ``SWEEP_RANGES_MIN_BYTES`` of target where its plan fits; form B where
    the target is at most ``SWEEP_WINDOWS`` windows."""
    size = torch.tensor([], dtype=dtype).element_size()
    forms = ["triton"]
    plan = cuda_scatter.range_plan(target, n, size)
    if target * size >= SWEEP_RANGES_MIN_BYTES \
            and plan.ranges <= cuda_scatter.MAX_RANGES \
            and plan.ranges * plan.tiles <= cuda_scatter.MATRIX_WORDS:
        forms.append("ranges")
    if mode != "store" \
            and cuda_scatter.window_plan(target, size)[1] <= SWEEP_WINDOWS:
        forms.append("privatized")
    return forms


def sweep(vex, ctx, cuda_scatter, events_ms):
    """"mode dtype 2^lg per" -> {form: events ms a call, "routed": the
    route's choice} over ``SWEEP_CELLS``: target lengths of 2^14 to 2^28
    bytes, ``SWEEP_PER_ELEMENT`` updates an element, and, where the target
    is at most ``SWEEP_WINDOWS`` windows of form B, ``SWEEP_DENSE``."""
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}
    for mode, dtype in SWEEP_CELLS:
        size = torch.tensor([], dtype=dtype).element_size()
        op = "add" if mode == "histogram" else mode
        for lb in SWEEP_BYTES_LOG2:
            target = (1 << lb) // size
            forms = _sweep_forms(cuda_scatter, mode, dtype, target, 1) \
                if cuda_scatter is not None else []
            dense = SWEEP_DENSE if "privatized" in forms else ()
            for per in SWEEP_PER_ELEMENT + dense:
                n = max(1, int(target * per))
                idx, val = _sweep_data(mode, dtype, target, n, gen, dev)
                iv = vex.vector._adopt(idx, ctx)
                xv = vex.vector._adopt(val, ctx) if val is not None else 1
                yv = vex.vector(target, dtype=dtype, context=ctx)
                if mode == "store":
                    def call():
                        vex.permutation(iv)(yv).assign(xv)
                else:
                    update = getattr(vex, "atomic_" + op)

                    def call():
                        vex.eval(update(vex.permutation(iv)(yv), xv))
                rec = {"api": events_ms(call)}
                if cuda_scatter is not None:
                    rec.update(_forced(cuda_scatter, call, events_ms,
                                       _sweep_forms(cuda_scatter, mode, dtype,
                                                    target, n)))
                    rec["routed"] = cuda_scatter.route(op, dtype, target, n)
                res[f"{mode} {str(dtype)[6:]} 2^{target.bit_length() - 1} "
                    + (f"1/{round(1 / per)}" if per < 1 else str(per))] = rec
                del iv, xv, yv, idx, val
    return res


def _forced(cuda_scatter, call, events_ms, forms):
    """{form: events ms of ``call`` with the route forced to it}."""
    routed = cuda_scatter.route
    out = {}
    try:
        for form in forms:
            cuda_scatter.route = (lambda *a, _f=form, **kw:
                                  None if _f == "triton" else _f)
            out[form] = events_ms(call)
    finally:
        cuda_scatter.route = routed
    return out


if __name__ == "__main__":
    main()
