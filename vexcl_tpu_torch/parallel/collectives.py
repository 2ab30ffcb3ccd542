"""Algorithms across the parts of a partitioned vector.

Port of ``vexcl_tpu/parallel/collectives.py`` and of the JAX package's
mesh-distributed scan (``vexcl_tpu/ops/scan.py:73-134``; the reference
does the same fix-up on the host, vexcl/scan.hpp:426-458):

1. each part with elements is scanned by the scan kernel
   (``cuda_scan.scan_apply``, one launch a part);
2. the parts' last values (their tails) are copied to the first part's
   device and scanned there (one more launch, of as many elements as
   parts);
3. each part after the first is left-combined with the scanned tail of
   the part before it, its carry, by one pass of the assignment kernel
   (``carry op y``, the carry a 0-d leaf on the part's device);
4. the exclusive shift and the ``init`` fold are the one-part path's
   tensor code (``ops/scan._exclusive_post``) on each part, the shift
   taking the value before the part from the scanned tails.

Floats are associated as the JAX package's distributed scan associates
them (a part's local prefix, then its carry), so an add scan over parts
agrees with the one-part kernel within rounding, bit for bit where the
sums are exact; max and min agree bit for bit.

The keyed scans over parts (``distributed_scan_by_key``) are the JAX
package's three-phase pair scan (``vexcl_tpu/ops/scan_by_key.py:160-209``):

1. each part with elements is scanned locally, its first element a head:
   one launch of the keyed kernel a part (``cuda_by_key.scan_by_key_apply``,
   inclusive, no ``init``); a custom ``op`` or ``key_eq`` takes the plain
   route per part (``scan_by_key.segment_flags``, ``seg_scan``);
2. a part's first element starts a run only where its keys differ from the
   last element of the part before (a one-element halo: ``h0``); the
   positions before a part's first head are ``L`` = its first head after
   element 0 (the map-reduce kernel's MIN over the keys' neighbour
   compares, one launch a part; the flags' plain MIN on the plain route),
   0 where ``h0``;
3. the parts' tail pairs (a head in the part, its last inclusive value)
   are scanned on the first part's device as the pair monoid (the
   segmented scan kernel, ``segscan_apply``; the plain ``associative_scan``
   for a custom ``op``), so a run longer than a part chains;
4. the fix-up: one launch of the assignment kernel a part writes the
   result into the target's part, ``op(carry, v)`` at the positions before
   the part's first head (the carry a 0-d leaf, the scanned tail before
   the part), with ``init`` and, for the exclusive scans, the shift and
   the heads of the one-part epilogue (``init``, or 0, at a head;
   ``op(init, previous inclusive value)`` elsewhere), the value before the
   part's first element the carry.

No step waits for the device.  Sums agree with one part within rounding,
bit for bit where they are exact; max and min bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["distributed_scan", "distributed_scan_by_key"]


def distributed_scan(src, dst, mono: str, fn, exclusive: bool,
                     init: Any):
    """The scan of the partitioned vector ``src`` with monoid ``mono``
    ("add", "max", "min"; ``fn`` its torch function) into ``dst`` (a new
    vector of src's partition where None)."""
    from ..expr.builtins import BUILTINS
    from ..expr.compile import _same_partition, evaluate
    from ..expr.node import ArrayTerminal, BinOp
    from ..ops.cuda_scan import scan_apply
    from ..vector import vector

    if dst is None:
        dst = vector._from_parts(src.context, src._pts, [
            torch.empty_like(p) for p in src.parts])
    _same_partition(dst, src)
    pts, devices = src._pts, src.context.devices
    nz = [int(d) for d in np.flatnonzero(np.diff(pts))]
    if not nz:
        return dst
    direct = (not exclusive and init is None and dst.dtype == src.dtype)
    ys = {}
    for d in nz:
        x = src._parts[d]
        ys[d] = scan_apply(x, mono, out=dst._parts[d] if direct else None)
    first = devices[nz[0]]
    tails = torch.cat([ys[d][-1:].to(first) for d in nz])
    carries = scan_apply(tails, mono)
    combine = {"add": lambda c, y: BinOp("add", c, y),
               "max": BUILTINS["max"], "min": BUILTINS["min"]}[mono]
    for k, d in enumerate(nz[1:]):
        y = ys[d]
        carry = ArrayTerminal(carries[k].to(y.device))
        evaluate(combine(carry, ArrayTerminal(y)), out=y)
    if direct:
        return dst
    for k, d in enumerate(nz):
        y = ys[d]
        if exclusive:
            prev = (carries[k - 1].to(y.device).reshape(1) if k
                    else y.new_zeros(1))
            y = torch.cat([prev, y[:-1]])
        if init is not None:
            iv = torch.tensor(init, dtype=y.dtype, device=y.device)
            y = fn(iv.expand(y.shape), y)
            if exclusive and k == 0:
                y = torch.cat([iv.reshape(1), y[1:]])
        dst._parts[d] = y.to(dst.dtype).contiguous()
    return dst


def _combine_expr(mono: Optional[str]):
    """The monoid's combine as an expression builder (c, y) -> node."""
    from ..expr.builtins import BUILTINS
    from ..expr.node import BinOp

    return {"add": lambda c, y: BinOp("add", c, y),
            "max": BUILTINS["max"], "min": BUILTINS["min"]}[mono]


def _neighbour_heads(ks: Sequence[torch.Tensor]):
    """The expression, over positions 1..m-1 of a part, that is true where
    a key differs from the one before (``k[:-1] != k[1:]``)."""
    from ..expr.node import ArrayTerminal, BinOp

    heads = None
    for k in ks:
        ne = BinOp("ne", ArrayTerminal(k[1:]), ArrayTerminal(k[:-1]))
        heads = ne if heads is None else BinOp("bitor", heads, ne)
    return heads


def _first_head(ks: Sequence[torch.Tensor], m: int) -> torch.Tensor:
    """The index of the part's first head after element 0 (m where there
    is none), a 0-d int64 tensor on its device: one launch of the
    map-reduce kernel (MIN)."""
    from ..expr.node import ElementIndex, Where
    from ..ops.reductor import MIN, _reduce

    if m == 1:
        return torch.ones((), dtype=torch.int64, device=ks[0].device)
    body = Where(_neighbour_heads(ks), ElementIndex() + 1, m)
    return _reduce([body], [MIN], m - 1, ks[0].device)[0].to(torch.int64)


def _plain_fixup(heads: torch.Tensor, y: torch.Tensor, lead, carry,
                 fn: Callable, exclusive: bool, init) -> torch.Tensor:
    """The plain route's fix-up of one part: ``fn(carry, y)`` before index
    ``lead`` (carry None for the first part), then the one-part epilogue
    over the part's true ``heads``, the value before the part the
    carry."""
    from ..ops.cuda_by_key import scan_by_key_epilogue

    if carry is not None:
        pos = torch.arange(y.shape[0], device=y.device)
        y = torch.where(pos < lead, fn(carry.expand(y.shape), y), y)
    res = scan_by_key_epilogue(heads, y, fn, exclusive, init)
    if exclusive and carry is not None:
        # element 0 follows the part before unless it is a head
        after = carry if init is None else fn(torch.tensor(
            init, dtype=y.dtype, device=y.device), carry)
        res[:1] = torch.where(heads[:1], res[:1], after)
    return res


def distributed_scan_by_key(keys: Sequence, src, dst, mono: Optional[str],
                            op: Optional[Callable],
                            key_eq: Optional[Callable], exclusive: bool,
                            init: Any):
    """The keyed scan of the partitioned vector ``src`` over runs of equal
    ``keys`` (partitioned vectors) into ``dst`` (a new vector of src's
    partition where None): the module docstring's steps.  ``mono`` is the
    standard monoid or None (a custom ``op``)."""
    from ..expr.compile import _same_partition, evaluate
    from ..expr.node import ArrayTerminal, ElementIndex, Where
    from ..ops.cuda_by_key import scan_by_key_apply
    from ..ops.cuda_scan import _OPS, associative_scan, segscan_apply
    from ..ops.scan_by_key import seg_scan, segment_flags
    from ..vector import vector

    for k in keys:
        _same_partition(k, src)
    if dst is None:
        dst = vector._from_parts(src.context, src._pts, [
            torch.empty_like(p) for p in src.parts])
    _same_partition(dst, src)
    pts = src._pts
    nz = [int(d) for d in np.flatnonzero(np.diff(pts))]
    if not nz:
        return dst
    fn = op if mono is None else _OPS[mono]
    kernel = mono is not None and key_eq is None
    first = src._parts[nz[0]].device
    incl, leads, flags = {}, [], {}
    for d in nz:
        ks = [k._parts[d] for k in keys]
        x, out = src._parts[d], dst._parts[d]
        m = x.shape[0]
        if kernel:
            direct = (not exclusive and out.dtype == x.dtype and not any(
                k.untyped_storage().data_ptr()
                == out.untyped_storage().data_ptr() for k in ks))
            incl[d] = scan_by_key_apply(ks, x, mono,
                                        out=out if direct else None)
            lead = _first_head(ks, m)
        else:
            flags[d], _ = segment_flags(tuple(ks), key_eq)
            incl[d] = seg_scan(flags[d], x, mono, op)
            pos = torch.arange(1, m + 1, device=x.device)
            lead = torch.where(flags[d][1:], pos[:-1], m).min() \
                if m > 1 else pos[0]
        leads.append(lead.to(first, non_blocking=True))
    # step 2: each part's first element against the last one before it
    firsts = [torch.cat([k._parts[d][:1].to(first) for d in nz])
              for k in keys]
    lasts = [torch.cat([k._parts[d][-1:].to(first) for d in nz])
             for k in keys]
    if key_eq is None:
        cut = torch.zeros(len(nz) - 1, dtype=torch.bool, device=first)
        for f, la in zip(firsts, lasts):
            cut |= f[1:] != la[:-1]
    else:
        cut = ~torch.as_tensor(key_eq(*[la[:-1] for la in lasts],
                                      *[f[1:] for f in firsts]),
                               dtype=torch.bool, device=first)
    h0 = torch.cat([cut.new_ones(1), cut])
    sizes = torch.tensor([int(pts[d + 1] - pts[d]) for d in nz],
                         device=first)
    lead = torch.stack(leads)
    lead = torch.where(h0, torch.zeros_like(lead), lead)
    # step 3: the tail pairs' scan, the carries
    seen = h0 | (lead < sizes)
    tails = torch.cat([incl[d][-1:].to(first) for d in nz])
    if mono is not None:
        scanned = segscan_apply(seen, tails, mono)
    else:
        scanned = associative_scan(lambda a, b: (a[0] | b[0], torch.where(
            b[0], b[1], op(a[1], b[1]))), (seen, tails))[1]
    # step 4: the fix-up, one launch a part
    for j, d in enumerate(nz):
        y, out = incl[d], dst._parts[d]
        dev = y.device
        carry = scanned[j - 1].to(dev) if j else None
        le = lead[j].to(dev)
        if not kernel:
            hd = torch.cat([h0[j:j + 1].to(dev), flags[d][1:]])
            res = _plain_fixup(hd, y, le, carry, fn, exclusive, init)
            out.copy_(res)
            continue
        iv = (None if init is None else
              ArrayTerminal(torch.tensor(init, dtype=y.dtype, device=dev)))
        comb = _combine_expr(mono)
        c = None if carry is None else ArrayTerminal(carry)
        if not exclusive:
            if c is None and iv is None and y is out:
                continue
            v = ArrayTerminal(y)
            if c is not None:
                v = Where(ElementIndex() < ArrayTerminal(le), comb(c, v), v)
            evaluate(v if iv is None else comb(iv, v), n=y.shape[0],
                     out=out)
            continue
        m = y.shape[0]
        ks = [k._parts[d] for k in keys]
        zero = torch.zeros((), dtype=y.dtype, device=dev)
        head_val = ArrayTerminal(zero) if iv is None else iv
        if m > 1:
            prev = ArrayTerminal(y[:-1])
            if c is not None:
                prev = Where(ElementIndex() < ArrayTerminal(le),
                             comb(c, prev), prev)
            rest = prev if iv is None else comb(iv, prev)
            evaluate(Where(_neighbour_heads(ks), head_val, rest), n=m - 1,
                     out=out[1:])
        # element 0: a head, or the carry
        v0 = head_val.array
        if carry is not None:
            after = carry if init is None else fn(v0, carry)
            v0 = torch.where(h0[j].to(dev), v0, after)
        out[:1].copy_(v0.reshape(1))
    return dst
