"""Cross-queue ordering: markers, barriers, explicit-queue assignment.

Port of ``vexcl_tpu/events.py`` (vexcl/backend/opencl/event.hpp:50-100 and
vexcl/enqueue.hpp:38-136).  On a card a queue is a CUDA stream:

* ``enqueue_marker`` records a ``torch.cuda.Event`` on the context's
  current stream; it completes when everything enqueued before it has;
* ``enqueue_barrier`` blocks the host until the context's device drains
  (``Context.finish``);
* ``enqueue(context)(x)[:] = expr`` runs the assignment on the target
  context's device: its leaves move there, and where the devices differ
  the vector migrates to the target, as in the JAX package;
  ``enqueue(context)(tie(x, y))`` and ``enqueue(context)(mv)`` do the
  same for a fused multi-assignment (one kernel for all components).

On the CPU every operation has completed when it returns: a marker is
complete at once.  Not ported: the complex host-transfer shims of the
TPU platform, and the distributed-SpMV check (no distributed matrices
yet).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .context import Context, current_context
from .expr.compile import ASSIGN_OPS, evaluate_multi
from .expr.node import ArrayTerminal, BinOp, Expr, VectorTerminal, as_expr

__all__ = ["Event", "enqueue_marker", "enqueue_barrier", "enqueue"]


class Event:
    """Completion handle (backend::event analog) over a CUDA event; on the
    CPU, complete from the start."""

    def __init__(self, event: Optional[torch.cuda.Event] = None):
        self._event = event

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    @property
    def complete(self) -> bool:
        return self._event is None or self._event.query()


def enqueue_marker(context: Optional[Context] = None) -> Event:
    ctx = context or current_context()
    if ctx.device.type != "cuda":
        return Event()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ctx.device))
    return Event(ev)


def enqueue_barrier(context: Optional[Context] = None) -> None:
    (context or current_context()).finish()


def _moved(expr: Expr, device: torch.device,
           memo: Dict[int, Expr]) -> Expr:
    """``expr`` with every array leaf on ``device`` (one copy per buffer,
    so a vector read twice stays one leaf)."""
    hit = memo.get(id(expr))
    if hit is not None:
        return hit
    if isinstance(expr, (VectorTerminal, ArrayTerminal)):
        t = expr.vec.storage if isinstance(expr, VectorTerminal) \
            else expr.array
        key = ("buf", id(t))
        out = memo.get(key)
        if out is None:
            out = memo[key] = ArrayTerminal(torch.as_tensor(t).to(device))
    elif not expr._elementwise:
        raise NotImplementedError(
            f"enqueue() onto another device moves elementwise expressions; "
            f"{type(expr).__name__} stays on its own device")
    elif expr.children:
        out = expr.with_children([_moved(c, device, memo)
                                  for c in expr.children])
    else:
        out = expr
    memo[id(expr)] = out
    return out


class _Redirected:
    """Assignment proxy that runs the kernel on the target context, for
    one vector or (``_RedirectedMulti``) several in one fused kernel."""

    def __init__(self, context: Context, vecs):
        self._context = context
        self._vecs = vecs

    def _exprs(self, value: Any):
        return [as_expr(value)]

    def assign(self, value: Any, op: str = "=") -> None:
        vecs, tgt = self._vecs, self._context
        exprs = self._exprs(value)
        if ASSIGN_OPS[op] is not None:
            exprs = [BinOp(ASSIGN_OPS[op], VectorTerminal(v), e)
                     for v, e in zip(vecs, exprs)]
        if all(tgt.device == v.context.device for v in vecs):
            evaluate_multi(exprs, [v.storage for v in vecs])
            return
        memo: Dict[Any, Expr] = {}
        outs = evaluate_multi([_moved(e, tgt.device, memo) for e in exprs],
                              n=vecs[0].size,
                              out_dtypes=[v.dtype for v in vecs],
                              device=tgt.device)
        # the vectors migrate to the context that computed them
        for v, out in zip(vecs, outs):
            v.context = tgt
            v._t = out

    def __setitem__(self, key, value) -> None:
        if not (isinstance(key, slice) and key == slice(None)):
            raise TypeError("enqueue()(x)[:] = expr")
        self.assign(value)

    def __iadd__(self, value):
        self.assign(value, "+=")
        return self

    def __isub__(self, value):
        self.assign(value, "-=")
        return self

    def __imul__(self, value):
        self.assign(value, "*=")
        return self

    def __itruediv__(self, value):
        self.assign(value, "/=")
        return self


class _RedirectedMulti(_Redirected):
    """enqueue()(tie(x, y)) / enqueue()(mv): a fused multi-assignment on
    the target context (enqueue.hpp:38-136 + assign_multiexpression)."""

    def _exprs(self, value: Any):
        from .multivector import _exprs_of

        return _exprs_of(value, len(self._vecs))


class _EnqueueTarget:
    def __init__(self, context: Context):
        self.context = context

    def __call__(self, target) -> _Redirected:
        from .multivector import _Tied, multivector
        from .vector import vector

        if isinstance(target, vector):
            return _Redirected(self.context, [target])
        if isinstance(target, _Tied):
            return _RedirectedMulti(self.context, target.vectors)
        if isinstance(target, multivector):
            return _RedirectedMulti(self.context, target.components)
        raise TypeError("enqueue() takes a vector, a tie() or a multivector")


def enqueue(context: Context) -> _EnqueueTarget:
    """vex::enqueue(queue_list)(x) = expr (enqueue.hpp:38-136): run the
    assignment's kernel on the given context's device."""
    return _EnqueueTarget(context)
