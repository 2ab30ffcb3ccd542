"""What the port's examples share: the context of ``--device``, the
card's name, and a timer (CUDA events on a card, the host clock on the
CPU)."""

import time

import torch

import vexcl_tpu_torch as vex


def context(device):
    """Every visible card (one part a card; the port never falls back to
    the CPU: no card raises), or the one device named (``cpu``,
    ``cuda:1``)."""
    if device is None:
        return vex.Context(vex.Filter.GPU)
    return vex.Context(device=device)


def device_name(ctx) -> str:
    """The card's name (the first part's), or "cpu"."""
    dev = ctx.device
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def ms_per_call(fn, ctx, reps: int = 10) -> float:
    """Milliseconds a call of ``fn`` after one warm-up call: CUDA events
    around ``reps`` calls on every card of the context (the slowest
    card's span), the host clock on the CPU.  Where ``fn`` returns a
    vector or a tensor, one element of the last result is read after the
    span (a small read, so that nothing of it is still queued)."""
    fn()
    if ctx.device.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    devs = sorted(set(ctx.devices), key=str)
    for d in devs:
        torch.cuda.synchronize(d)
    events = {}
    for d in devs:
        with torch.cuda.device(d):
            events[d] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            events[d][0].record()
    out = None
    for _ in range(reps):
        out = fn()
    for d in devs:
        with torch.cuda.device(d):
            events[d][1].record()
    for s, e in events.values():
        e.synchronize()
    out = getattr(out, "storage", out)
    if isinstance(out, torch.Tensor) and out.numel():
        float(out.reshape(-1)[0].real)
    return max(s.elapsed_time(e) for s, e in events.values()) / reps
