#!/usr/bin/env python3
"""Where the host time of one call goes, step by step, for the generated
Triton kernels of the package at DIR, in the version that launched them
through ``fn[grid]`` (before the launch records of ``_build.py``):

    python3 scripts/torch_host_breakdown.py DIR

imports ``vexcl_tpu_torch`` from DIR and times, on the host clock (the
mean over 20 batches of 100 calls, no synchronisation inside a batch and
one between batches, outside the clock, so that a launch never waits for
room in the launch queue; one warm call first), each step of four calls at ``chip_smoke.py``'s sizes: the V2 row
sums of a 4096^2 f32 grid through ``reduce_view_apply``, K2's MIN_MAX of
2^24 f32 through ``map_reduce_multi``, the assignment ``x[:] = r +
0.7*p`` at 2^24 f32 and ``LorenzEnsemble(2^22).step()`` in f32.  The
steps are the wrapper's own (layout, plan, key, cache lookup, argument
list) and Triton's (``JITFunction.run``: its binder, its cache key, the
launch metadata, the launcher), each called alone on the same prepared
arguments, and the candidates for a direct launch: the compiled
kernel's launcher (``CompiledKernel.run``) with tensors or with pointers
as integers, and that launcher's C entry point.  Prints one JSON line with the card's name and power limit.
It reaches into the wrappers' internals of that version and is meant for
the tree before the launch records (``git archive`` of a commit before
them); ``scripts/torch_host_turns.py`` times whole calls of any version.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, BATCHES = 100, 20


def us(fn, batches=BATCHES):
    """Host µs a call of fn: batches of BATCH calls, each started on an
    idle card, no sync inside a batch."""
    fn()
    total = 0.0
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(BATCH):
            fn()
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return total / (batches * BATCH) * 1e6


def triton_steps(jit, grid, args, opts):
    """Triton's launch path of ``jit[grid](*args, **opts)``, step by step."""
    from triton import knobs
    from triton.runtime.driver import driver
    from triton.runtime.jit import compute_cache_key

    jit[grid](*args, **opts)
    device = driver.active.get_current_device()
    stream = driver.active.get_current_stream(device)
    kcache, kkcache, _, _, binder = jit.device_caches[device]
    kw = dict(opts, debug=jit.debug or knobs.runtime.debug,
              instrumentation_mode=knobs.compilation.instrumentation_mode)
    bound, spec, options = binder(*args, **kw)
    key = compute_cache_key(kkcache, spec, options)
    kernel = kcache[key]
    vals = list(bound.values())
    g = tuple(grid) + (1,) * (3 - len(grid))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in vals]
    return {
        "fn[grid] whole": us(lambda: jit[grid](*args, **opts)),
        "get_current_device + stream": us(
            lambda: driver.active.get_current_stream(
                driver.active.get_current_device())),
        "binder": us(lambda: binder(*args, **kw)),
        "compute_cache_key": us(lambda: compute_cache_key(kkcache, spec,
                                                          options)),
        "launch_metadata": us(lambda: kernel.launch_metadata(grid, stream,
                                                             *vals)),
        "kernel.run (tensors)": us(lambda: kernel.run(
            *g, stream, kernel.function, kernel.packed_metadata, None, None,
            None, *vals)),
        "kernel.run (data_ptr ints)": us(lambda: kernel.run(
            *g, stream, kernel.function, kernel.packed_metadata, None, None,
            None, *ptrs)),
        "kernel.run.launch (its C entry point)": us(lambda: kernel.run.launch(
            *g, stream, kernel.function, kernel.run.launch_cooperative_grid,
            kernel.run.launch_pdl, None, None, kernel.packed_metadata, None,
            None, None, *ptrs)),
        "raw stream (torch._C)": us(
            lambda: torch._C._cuda_getCurrentRawStream(0)),
        "data_ptr of each tensor": us(lambda: [
            a.data_ptr() for a in vals if isinstance(a, torch.Tensor)]),
        "args": len(vals),
    }


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import vexcl_tpu_torch as vex
    from vexcl_tpu_torch.cache import kernel_cache
    from vexcl_tpu_torch.expr import compile as cmp
    from vexcl_tpu_torch.expr import triton_emit as te
    from vexcl_tpu_torch.expr.node import analyze, as_expr, infer_types
    from vexcl_tpu_torch.ops import triton_reduce as tr
    from vexcl_tpu_torch.ops import triton_reduce_view as trv

    assert os.path.abspath(vex.__file__).startswith(root), vex.__file__
    ctx = vex.Context(vex.Filter.GPU)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(n, dt=torch.float32):
        return vex.vector(data=torch.rand(n, generator=gen, device=dev,
                                          dtype=dt), context=ctx)

    out = {}
    # V2: row sums of 4096^2 f32
    g = 4096
    x = rand(g * g)
    node = vex.reduce_view("sum", vex.slicer((g, g))[:, :](x), 1)
    a = trv.prepare_reduce_view(node, dev)
    inner, an, ty, lv, op, shape, axes, o = a
    trv.reduce_view_apply(*a)
    kc, kf, rc, rf, r_fast, pattern = trv._layout(shape, axes)
    n_out, nred = g, g
    pl = trv.plan(n_out, nred, r_fast, 4, tr._programs(o.device))
    key = ("reduce_view", op, pattern, pl.ot, pl.rt,
           pl.unroll) + te.kernel_key(an, (o.dtype,))
    k = kernel_cache.get(key)
    ints = [n_out, nred, *kc[1:], *kf, *rc[1:], *rf]
    vargs = (o, o, o, *te.launch_args(lv), ints[0], ints[1], pl.chunk,
             pl.nsplit, *ints[2:])
    vopts = dict(OT=pl.ot, RT=pl.rt, BLOCK=pl.ot * pl.rt, SPLIT=False,
                 num_warps=trv.REDUCE_VIEW_WARPS)
    out["reduce_view_rowsum_f32"] = {
        "whole call": us(lambda: trv.reduce_view_apply(*a)),
        "_layout": us(lambda: trv._layout(shape, axes)),
        "two np.prod": us(lambda: (int(np.prod(kc, dtype=np.int64)),
                                   int(np.prod(rc, dtype=np.int64)))),
        "_programs": us(lambda: tr._programs(o.device)),
        "plan": us(lambda: trv.plan(n_out, nred, r_fast, 4, 528)),
        "kernel_key": us(lambda: te.kernel_key(an, (o.dtype,))),
        "cache lookup": us(lambda: kernel_cache.get_or_create(key, None)),
        "launch_args": us(lambda: te.launch_args(lv)),
        "current_device": us(torch.cuda.current_device),
        "triton": triton_steps(k.fn, (pl.tiles, pl.nsplit), vargs, vopts),
        "plan_split": pl.nsplit}
    del x, a, o
    # K2: MIN_MAX of 2^24 f32
    n = 1 << 24
    u = rand(n)
    e, an, ty, lv = cmp.prepare_multi([u], n, dev)
    pairs = [(e[0], "MIN"), (e[0], "MAX")]
    tr.map_reduce_multi(pairs, an, ty, lv, n, dev)
    shape = ((0, "MIN"), (0, "MAX"))
    key = ("reduce", shape) + te.kernel_key(an, None)
    k = kernel_cache.get(key)
    part, ticket = tr._scratch_for(dev, k.words)
    ro = torch.empty(2, dtype=torch.int64, device=dev)
    ntiles = -(-n // k.block)
    nprog = min(ntiles, tr._programs(dev))
    rargs = (part, ticket, ro, *te.launch_args(lv), n, ntiles, part.shape[1])
    ropts = dict(BLOCK=k.block, FINAL=tr.FINAL_BLOCK,
                 num_warps=tr.REDUCE_WARPS)
    views = lambda: [ro.view(torch.float32)[i * 2] for i in range(2)]
    out["map_reduce_multi_min_max_f32"] = {
        "whole call": us(lambda: tr.map_reduce_multi(pairs, an, ty, lv, n,
                                                     dev)),
        "shape tuple": us(lambda: tuple(
            ({}.setdefault(id(b), 0), kd) for b, kd in pairs)),
        "kernel_key": us(lambda: te.kernel_key(an, None)),
        "cache lookup": us(lambda: kernel_cache.get_or_create(key, None)),
        "_scratch_for": us(lambda: tr._scratch_for(dev, k.words)),
        "torch.empty out": us(lambda: torch.empty(2, dtype=torch.int64,
                                                  device=dev)),
        "launch_args": us(lambda: te.launch_args(lv)),
        "current_device": us(torch.cuda.current_device),
        "result views": us(views),
        "triton": triton_steps(k.fn, (nprog,), rargs, ropts)}
    del u, e, lv, part, ticket, ro
    # the assignment x[:] = r + 0.7*p, 2^24 f32
    xv, r, p = rand(n), rand(n), rand(n)

    def api():
        xv[:] = r + 0.7 * p
    expr = r + 0.7 * p
    ex = as_expr(expr)
    h = cmp.hoist(ex, dev, n)
    an = analyze(h)
    ty = infer_types(h)
    lv = cmp._check_leaves([h], an, n, dev)
    key = ("assign", None) + te.kernel_key(an, (torch.float32,))
    k = kernel_cache.get(key)
    if k is None:
        te.assign(h, an, ty, lv, xv.storage)
        k = kernel_cache.get(key)
    aargs = (xv.storage, *te.launch_args(lv), n)
    aopts = dict(BLOCK=te.ASSIGN_BLOCK, num_warps=4)

    def dev_ctx():
        with torch.cuda.device(dev):
            pass
    out["assign_r_plus_07p_f32"] = {
        "whole call (x[:] = r + 0.7*p)": us(api),
        "building r + 0.7*p": us(lambda: r + 0.7 * p),
        "evaluate (prepared tree)": us(lambda: cmp.evaluate(
            expr, n=n, out=xv.storage)),
        "hoist": us(lambda: cmp.hoist(ex, dev, n)),
        "analyze": us(lambda: analyze(h)),
        "infer_types": us(lambda: infer_types(h)),
        "_check_leaves": us(lambda: cmp._check_leaves([h], an, n, dev)),
        "kernel_key": us(lambda: te.kernel_key(an, (torch.float32,))),
        "cache lookup": us(lambda: kernel_cache.get_or_create(key, None)),
        "launch_args": us(lambda: te.launch_args(lv)),
        "with torch.cuda.device": us(dev_ctx),
        "assign (prepared)": us(lambda: te.assign(h, an, ty, lv,
                                                  xv.storage)),
        "triton": triton_steps(k.fn, (-(-n // te.ASSIGN_BLOCK),), aargs,
                               aopts)}
    del xv, r, p, lv, aargs
    # the Lorenz RK4 step, 2^22 f32
    from vexcl_tpu_torch.models import LorenzEnsemble

    ens = LorenzEnsemble(1 << 22, dtype=np.float32, context=ctx, seed=0)
    kern = ens._step
    args = (ens.x, ens.y, ens.z, ens.R)
    ens.step()
    e, an, ty, lv, outs = kern.prepare(*args)
    kern._bind(args)
    try:
        hs = [cmp.hoist(as_expr(x_), dev, ens.n, {}) for x_ in kern._exprs]
        bind_steps = {
            "hoist": us(lambda: [cmp.hoist(as_expr(x_), dev, ens.n, {})
                                 for x_ in kern._exprs], 5),
            "analyze": us(lambda: analyze(*hs), 5),
            "infer_types": us(lambda: infer_types(*hs), 5),
            "_check_leaves": us(lambda: cmp._check_leaves(hs, an, ens.n,
                                                          dev), 5)}
    finally:
        kern._unbind()
    key = ("assign", None) + te.kernel_key(
        an, tuple(o_.dtype for o_ in outs))
    k = kernel_cache.get(key)
    largs = (*outs, *te.launch_args(lv), ens.n)
    out["lorenz_step_f32"] = {
        "whole call (ens.step())": us(ens.step, 5),
        "Kernel.prepare": us(lambda: kern.prepare(*args), 5),
        **bind_steps,
        "_targets + _bind + _unbind": us(lambda: (
            kern._targets(args), kern._bind(args), kern._unbind())),
        "kernel_key": us(lambda: te.kernel_key(
            an, tuple(o_.dtype for o_ in outs))),
        "launch_args": us(lambda: te.launch_args(lv)),
        "assign_multi (prepared)": us(lambda: te.assign_multi(
            e, an, ty, lv, outs), 5),
        "triton": triton_steps(k.fn, (-(-ens.n // te.ASSIGN_BLOCK),),
                               largs, aopts),
        "leaves": len(lv)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    import triton
    print(json.dumps({"root": root, "card": card,
                      "triton": triton.__version__,
                      "torch": torch.__version__, "calls": BATCH * BATCHES,
                      "host_us": out}))


if __name__ == "__main__":
    main()
