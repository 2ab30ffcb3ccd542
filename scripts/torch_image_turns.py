#!/usr/bin/env python3
"""Image samples and ``slicer[i, j]`` through the public API, for
comparing two versions of ``vexcl_tpu_torch`` in turns on one card and
for setting the routes' thresholds (``ops/image.patch_route``,
``ops/cuda_gather.index_route``):

    python3 scripts/torch_image_turns.py DIR [--sweep] [--json FILE]

imports the package from DIR (a checkout, or a ``git archive`` of another
commit unpacked there) and prints one JSON line with, for each call at
``chip_smoke.py``'s phase-15 sizes, the host µs a call, the events ms of
back-to-back calls and the profiler's device µs a call of every kernel it
launches, beside its PyTorch call: ``z[:] = img(X, Y)`` of a 4096^2 f32
image at 2^24 f32 points uniform over it, bilinear and nearest, beside
``grid_sample`` (padding "border", ``align_corners=True``), and
``z[:] = slicer((4096, 4096))[i, j](x)`` with 2^24 random i32 keys beside
PyTorch's ``x[i, j]``.  Each result is checked first: nearest samples
and ``[i, j]`` bitwise against the same function in tensor code, bilinear
ones within 8e-6 of the image's magnitude.  Run versions in turns in one
chip call (parent, change, change, parent), one process each.

Where the tree has the forms (``ops/image.FORCE``,
``expr/triton_emit.INDEX_GATHER``), each call is also timed with each
form forced (``forms``: the four taps and the patch table; V1 and the
gather form's fused variant), with the
patch table's build ms and the count of 16-byte loads in the patched
kernel's PTX.

``--sweep`` (a tree with the forms) adds the events ms a call of each
form forced over f32, f64 and i32 images of 2^14 to 2^28 bytes, 1/16 to
16 points a texel (at most 2^26), uniform points and clustered ones (each
run of 1024 points within a 32-texel square), and ``[i, j]`` of uniform
keys over the same grids, with each route's choice.
"""

import argparse
import json
import math
import os
import re
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 4096
N = 1 << 24
SWEEP_TYPES = (torch.float32, torch.float64, torch.int32)
SWEEP_BYTES_LOG2 = range(14, 29)
SWEEP_PER_TEXEL = (1 / 16, 1 / 4, 1, 4, 16)
SWEEP_MAX_N = 1 << 26
#: clustered points: runs of this many points within a square of CLUSTER
CLUSTER_RUN, CLUSTER = 1024, 32
#: events of a sweep point: about this many ms of calls, 3 to 100 calls
SWEEP_MS = 20.0


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
    from torch_gather_turns import events_ms
    from torch_host_turns import host_us
    from vexcl_tpu_torch.expr import triton_emit
    from vexcl_tpu_torch.ops import image

    forms = hasattr(image, "FORCE")
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": smi_line(), "root": root, "forms": forms}
    img = torch.rand(GRID, GRID, generator=gen, device=dev)
    X = vex.vector(data=torch.rand(N, generator=gen, device=dev)
                   * (GRID - 1), context=ctx)
    Y = vex.vector(data=torch.rand(N, generator=gen, device=dev)
                   * (GRID - 1), context=ctx)
    z = vex.vector(N, dtype=torch.float32, context=ctx)
    grid = torch.stack([X.storage / (GRID - 1) * 2 - 1,
                        Y.storage / (GRID - 1) * 2 - 1], -1).view(1, 1, N, 2)
    inp = img.view(1, 1, GRID, GRID)
    for filt, mode in (("linear", "bilinear"), ("nearest", "nearest")):
        im = vex.image2d(img, filter=filt, context=ctx)
        want = reference(img, X.storage, Y.storage, filt)

        def call():
            z[:] = im(X, Y)

        def lib(mode=mode):
            return torch.nn.functional.grid_sample(
                inp, grid, mode=mode, padding_mode="border",
                align_corners=True)
        rec = {"api": timed(call, profile_call, host_us, events_ms),
               "library": timed(lib, profile_call, host_us, events_ms)}
        call()
        check(z.storage, want, filt)
        if forms:
            rec["forms"] = {}
            for form, set_form in form_setters(filt, image, triton_emit):
                set_form()
                # a sample made now takes the forced form
                im_f = vex.image2d(img, filter=filt, context=ctx)

                def forced(im_f=im_f):
                    z[:] = im_f(X, Y)
                forced()
                check(z.storage, want, filt)
                rec["forms"][form] = timed(forced, profile_call, host_us,
                                           events_ms)
                set_form(None)
            if filt == "linear":
                table = image.patch_table(img)
                rec["table_build_ms"] = events_ms(
                    lambda: image.patch_table(img, table))
                rec["ptx_16_byte_loads"] = wide_loads(vex, im, X, Y)
        out[f"image_{filt}"] = rec
        print(json.dumps(rec), file=sys.stderr)
        del im
    x = vex.vector(data=torch.rand(GRID * GRID, generator=gen, device=dev),
                   context=ctx)
    gi = vex.vector(data=torch.randint(0, GRID, (N,), generator=gen,
                                       device=dev, dtype=torch.int32),
                    context=ctx)
    gj = vex.vector(data=torch.randint(0, GRID, (N,), generator=gen,
                                       device=dev, dtype=torch.int32),
                    context=ctx)
    i64, j64 = gi.storage.long(), gj.storage.long()
    grid2 = x.storage.view(GRID, GRID)
    view = vex.slicer((GRID, GRID))[gi, gj](x)

    def ij():
        z[:] = view

    def ij_lib():
        return grid2[i64, j64]
    rec = {"api": timed(ij, profile_call, host_us, events_ms),
           "library": timed(ij_lib, profile_call, host_us, events_ms)}
    ij()
    check(z.storage, ij_lib(), "nearest")
    if forms:
        rec["forms"] = {}
        for form, set_form in form_setters("nearest", image, triton_emit):
            set_form()
            ij()
            check(z.storage, ij_lib(), "nearest")
            rec["forms"][form] = timed(ij, profile_call, host_us, events_ms)
            set_form(None)
    out["advanced_index"] = rec
    print(json.dumps(rec), file=sys.stderr)
    del x, gi, gj, i64, j64, grid2, view, X, Y, z, grid, inp, img
    torch.cuda.empty_cache()
    if args.sweep and forms:
        out["sweep"] = sweep(vex, ctx, image, triton_emit, events_ms)
    line = json.dumps(out)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line)


def timed(fn, profile_call, host_us, events_ms):
    """{"host_us", "ms", "device_us", "kernels"} of fn."""
    per_kernel, _ = profile_call(fn, 20)
    return {"host_us": host_us(fn), "ms": events_ms(fn),
            "device_us": sum(per_kernel.values()), "kernels": per_kernel}


def form_setters(filt, image, triton_emit):
    """(form, setter) for each form of ``filt``'s samples: the setter
    forces the form, and with None lifts the force."""
    def setter(module, name, value):
        def apply(v=value):
            setattr(module, name, v)
        return apply
    if filt == "linear":
        return [("taps", setter(image, "FORCE", "taps")),
                ("patch", setter(image, "FORCE", "patch"))]
    return [(form, setter(triton_emit, "INDEX_GATHER", form))
            for form in ("v1", "fused")]


def reference(img, X, Y, filt):
    """The sample in tensor code (the JAX package's formula; nearest
    samples of coordinates inside the image)."""
    h, w = img.shape
    if filt == "nearest":
        return img[torch.round(Y).long().clamp(0, h - 1),
                   torch.round(X).long().clamp(0, w - 1)]
    x, y = X.clamp(0, w - 1), Y.clamp(0, h - 1)
    x0, y0 = x.floor(), y.floor()
    tx, ty = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    return (img[y0, x0] * (1 - tx) * (1 - ty) + img[y0, x1] * tx * (1 - ty)
            + img[y1, x0] * (1 - tx) * ty + img[y1, x1] * tx * ty)


def check(got, want, filt):
    if filt == "nearest":
        bits = {4: torch.int32, 8: torch.int64}[got.element_size()]
        assert torch.equal(got.view(bits), want.view(bits)), filt
        return
    scale = max(1.0, want.abs().max().item())
    err = (got.double() - want.double()).abs().max().item()
    assert err <= 8e-6 * scale, (filt, err)


def wide_loads(vex, im, X, Y):
    """{"v4.b32", "v2.b64", ...: count} of the 16-byte loads in the PTX
    of the assignment kernel of ``im(X, Y)`` (the patch form where the
    image takes it)."""
    from vexcl_tpu_torch.expr.compile import prepare
    from vexcl_tpu_torch.expr.triton_emit import (_AssignKernel,
                                                  assign_source,
                                                  launch_args, launch_shape,
                                                  tensor_arg)

    n = X.size
    e, an, ty, lv = prepare(im(X, Y), n, X.storage.device)
    k = _AssignKernel(assign_source(e, an, ty, "f32"),
                      shape=launch_shape([e]))
    out = torch.empty(n, device=X.storage.device)
    compiled = k.launcher.jit_launch(
        (-(-n // k.consts[0]),), [tensor_arg(out), *launch_args(lv)], (n,),
        k.consts, X.storage.device)
    counts = {}
    for v, b in re.findall(r"ld\.global[\w.:]*?\.v(\d)\.b(\d+)",
                           compiled.asm["ptx"]):
        counts[f"v{v}.b{b}"] = counts.get(f"v{v}.b{b}", 0) + 1
    return counts


def _points(n, h, w, clustered, gen, dev, dt):
    """n (x, y) points over an (h, w) image: uniform, or runs of
    ``CLUSTER_RUN`` within a ``CLUSTER``-texel square each."""
    if not clustered:
        return (torch.rand(n, generator=gen, device=dev) * (w - 1),
                torch.rand(n, generator=gen, device=dev) * (h - 1))
    runs = -(-n // CLUSTER_RUN)
    cx = torch.rand(runs, generator=gen, device=dev) * max(w - CLUSTER, 0)
    cy = torch.rand(runs, generator=gen, device=dev) * max(h - CLUSTER, 0)
    ox = torch.rand(runs, CLUSTER_RUN, generator=gen, device=dev) * min(
        CLUSTER, w - 1)
    oy = torch.rand(runs, CLUSTER_RUN, generator=gen, device=dev) * min(
        CLUSTER, h - 1)
    return ((cx[:, None] + ox).reshape(-1)[:n],
            (cy[:, None] + oy).reshape(-1)[:n])


def sweep(vex, ctx, image, triton_emit, events_ms):
    """"dtype 2^lg per points" -> {"taps", "patch", "v1", "fused": events
    ms a call, "patch_routed", "index_routed": the routes' choices; for
    uniform points "ij_v1", "ij_fused"}."""
    from vexcl_tpu_torch.config import config
    from vexcl_tpu_torch.ops import cuda_gather

    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}
    try:
        for dt in SWEEP_TYPES:
            size = torch.tensor([], dtype=dt).element_size()
            for lb in SWEEP_BYTES_LOG2:
                texels = (1 << lb) // size
                h = 1 << (int(math.log2(texels)) // 2)
                w = texels // h
                data = torch.randint(-1000, 1000, (h, w), generator=gen,
                                     device=dev).to(dt)
                flat = vex.vector._adopt(data.view(-1), ctx)
                for per in SWEEP_PER_TEXEL:
                    n = max(1, int(texels * per))
                    if n > SWEEP_MAX_N:
                        continue
                    z = vex.vector(n, dtype=dt, context=ctx)
                    for clustered in (False, True):
                        px, py = _points(n, h, w, clustered, gen, dev, dt)
                        X = vex.vector._adopt(px, ctx)
                        Y = vex.vector._adopt(py, ctx)
                        rec = {}
                        for filt, forms in (
                                ("linear", (("taps", "taps"),
                                            ("patch", "patch"))),
                                ("nearest", (("v1", "v1"),
                                             ("fused", "fused")))):
                            for form, value in forms:
                                if filt == "linear":
                                    image.FORCE = value
                                else:
                                    triton_emit.INDEX_GATHER = value
                                im = vex.image2d(data, filter=filt,
                                                 context=ctx)
                                expr = im(X, Y)

                                def call(expr=expr):
                                    z[:] = expr
                                rec[form] = events_ms(call, SWEEP_MS)
                            image.FORCE = None
                            triton_emit.INDEX_GATHER = None
                        rec["patch_routed"] = image.patch_route(
                            dt, h, w, config.img_patch_mb)
                        rec["index_routed"] = cuda_gather.index_route(
                            dt, texels, n)
                        if not clustered:
                            ki = vex.vector._adopt(torch.randint(
                                0, h, (n,), generator=gen, device=dev,
                                dtype=torch.int32), ctx)
                            kj = vex.vector._adopt(torch.randint(
                                0, w, (n,), generator=gen, device=dev,
                                dtype=torch.int32), ctx)
                            view = vex.slicer((h, w))[ki, kj](flat)
                            for form, value in (("ij_v1", "v1"),
                                                ("ij_fused", "fused")):
                                triton_emit.INDEX_GATHER = value

                                def ij(view=view):
                                    z[:] = view
                                rec[form] = events_ms(ij, SWEEP_MS)
                            triton_emit.INDEX_GATHER = None
                            del ki, kj, view
                        per_s = (f"1/{round(1 / per)}" if per < 1
                                 else str(per))
                        res[f"{str(dt)[6:]} 2^{lb} {per_s} "
                            f"{'clustered' if clustered else 'uniform'}"] = rec
                        del X, Y, px, py
                    del z
                del data, flat
                torch.cuda.empty_cache()
    finally:
        image.FORCE = None
        triton_emit.INDEX_GATHER = None
    return res


if __name__ == "__main__":
    main()
