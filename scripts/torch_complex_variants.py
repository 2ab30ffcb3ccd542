#!/usr/bin/env python3
"""The complex forms of the generated kernels beside their PyTorch calls
and beside other forms of the complex load, in turns on one card:

    python3 scripts/torch_complex_variants.py [--json FILE]

At 2^24 elements, c64 and c128: the sum ``Reductor(SUM)(fx)``'s kernel
(K2 with (re, im) accumulators) beside ``torch.sum`` and beside the real
sum of as many bytes (``Sum(a * b)`` of two real vectors), and the
assignment ``p[:] = fx * conj(fx)`` beside ``torch.mul(fx, fx.conj())``,
each kernel built in every form of ``VARIANTS``:

* ``tile``: the port's load, a (BLOCK, 2) tile split by ``tl.split``;
* ``flat``: the same elements loaded as one flat block of 2 BLOCK words,
  reshaped to (BLOCK, 2) and split;
* ``strided``: two loads, the real parts at even words and the imaginary
  parts at odd ones;
* ``tile_4096``: the port's load, the sum's tiles of 4096 elements
  (where the port takes 2048 for a complex sum).

Each result is checked against its plain form first.  Prints one JSON
line: events ms (the median of ``chip_smoke.TURNS`` timings of 100
launches, in turns, with their range) and device µs a call by the
profiler (``chip_smoke.profile_call``), with the card's name and power
limit.
"""

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
N = 1 << 24
VARIANTS = ("tile", "flat", "strided", "tile_4096")


def _load_variant(form):
    """An ``Emitter._load_complex`` whose element's-own-index load takes
    ``form`` (``flat`` or ``strided``); other contexts keep the port's."""
    from vexcl_tpu_torch.expr import triton_emit as te

    port = te.Emitter._load_complex

    def load(self, slot, leaf):
        if leaf.ndim == 0 or self.at != te.BASE:
            return port(self, slot, leaf)
        key = ("load", slot, self.at)
        if key not in self._slots:
            v = f"x{slot}"
            if form == "flat":
                self.lines += [
                    f"{v}_o = tl.reshape((offs * 2)[:, None] + "
                    "tl.arange(0, 2)[None, :], (2 * BLOCK,))",
                    f"{v}_m = tl.reshape(tl.broadcast_to(mask[:, None], "
                    "(BLOCK, 2)), (2 * BLOCK,))",
                    f"{v}_ri = tl.reshape(tl.load(p{slot} + {v}_o, "
                    f"mask={v}_m), (BLOCK, 2))",
                    f"{v}_re, {v}_im = tl.split({v}_ri)"]
            else:
                self.lines += [
                    f"{v}_re = tl.load(p{slot} + offs * 2, mask=mask)",
                    f"{v}_im = tl.load(p{slot} + offs * 2 + 1, mask=mask)"]
            self._slots[key] = (f"{v}_re", f"{v}_im")
        return self._slots[key]
    return load


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.cache import kernel_cache
    from vexcl_tpu_torch.expr import triton_emit as te
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.ops import triton_reduce as tr

    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": cs.smi_line(), "n": N}
    port_load, port_block = te.Emitter._load_complex, tr._block
    for dt in (torch.complex64, torch.complex128):
        rt = dt.to_real()
        fx = vex.vector._adopt(torch.complex(
            torch.rand(N, generator=gen, device=dev, dtype=rt) - 0.5,
            torch.rand(N, generator=gen, device=dev, dtype=rt) - 0.5), ctx)
        a, b = (vex.vector._adopt(torch.rand(N, generator=gen, device=dev,
                                             dtype=rt), ctx)
                for _ in range(2))
        p = torch.empty_like(fx.storage)
        es, an_s, ty_s, lv_s = prepare(fx, N, dev)
        ea, an_a, ty_a, lv_a = prepare(fx * vex.conj(fx), N, dev)
        er, an_r, ty_r, lv_r = prepare(a * b, N, dev)
        want_s = tr.map_reduce_plain(es, an_s, ty_s, lv_s, N, "SUM", dev)
        want_a = torch.empty_like(p)
        te.assign_plain(ea, an_a, ty_a, lv_a, want_a)
        fns = {"torch.sum": lambda: torch.sum(fx.storage),
               "torch.mul": lambda: torch.mul(fx.storage, fx.storage.conj()),
               "real_sum": lambda: tr.map_reduce(er, an_r, ty_r, lv_r, N,
                                                 "SUM", dev)}
        stol = 1e-5 if dt == torch.complex64 else 1e-10
        for form in VARIANTS:
            kernel_cache.purge()
            te.Emitter._load_complex = (port_load if form.startswith("tile")
                                        else _load_variant(form))
            tr._block = (port_block if form != "tile_4096"
                         else (lambda words: 8192))
            try:
                # build this form's kernels now, and check them
                got = tr.map_reduce(es, an_s, ty_s, lv_s, N, "SUM", dev)
                te.assign(ea, an_a, ty_a, lv_a, p)
                torch.cuda.synchronize()
            finally:
                te.Emitter._load_complex, tr._block = port_load, port_block
            err = abs(got.item() - want_s.item()) / max(1.0,
                                                        abs(want_s.item()))
            if err > stol or not torch.allclose(p, want_a, rtol=1e-6):
                raise SystemExit(f"{form} {dt}: wrong ({err})")
            # the launch records keep this form's compiled kernels
            fns[f"sum_{form}"] = (lambda k=kernel_cache.get(
                ("reduce", ((0, "SUM"),)) + te.kernel_key(an_s, None)):
                k.launch(lv_s, N, dev))
            key, _ = te.launch_key([ea], an_a, [dt])
            fns[f"assign_{form}"] = (lambda k=kernel_cache.get(key):
                                     k.launch([p], lv_a, N))
        turns = cs.in_turns(fns)
        res = {}
        for name, fn in fns.items():
            per_kernel, _ = cs.profile_call(fn, cs.KERNEL_REPS)
            res[name] = {"ms": turns[name]["ms"],
                         "ms_range": turns[name]["ms_range"],
                         "device_us": sum(per_kernel.values())}
        out[str(dt).replace("torch.", "")] = res
        del fx, a, b, p, want_a
        kernel_cache.purge()
        torch.cuda.empty_cache()
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
