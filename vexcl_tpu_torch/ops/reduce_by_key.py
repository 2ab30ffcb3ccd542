"""Segmented reduction: reduce_by_key.

Port of ``vexcl_tpu/ops/reduce_by_key.py`` (vexcl/reduce_by_key.hpp:
435-585).  The three standard monoids without ``key_eq`` are one launch
of the keyed kernel of ``cuda_by_key.py`` (on the CPU, its plain
version): head flags from the keys, the segmented scan and the packing
of each run's total and tail key in one pass, the run count on the
device.  The count then crosses to the host once, as the reference
resizes its outputs there, and the outputs are the kernel's buffers
sliced to it.  A custom ``op`` or a Python ``key_eq`` cannot enter a CUDA
kernel: there the head and tail flags come from one plain comparison of
neighbouring keys, the segmented scan (``cuda_scan.segscan_apply``, or
``associative_scan`` for a custom ``op``) leaves each run's total at its
tail, and the compaction kernel (``cuda_compact.compact_apply``) packs
the tails' totals and keys in order.  With a custom ``key_eq`` the keys
of one run may differ, and each run reports its FIRST key (the heads are
compacted for the keys, the tails for the values).  Returns ``(okeys,
ovals, count)``; ``okeys``/``ovals`` containers, when passed, are resized
and filled.

The JAX package picks among a fused Pallas kernel (n <= 2^24), a
block-compaction pipeline with a sort epilogue (larger n) and a generic
sort-based path; on Hopper the scatter makes one kernel serve every n.

Over the parts of partitioned vectors (``_reduce_parts``) each part with
elements is reduced as one part is (one ``reduce_by_key_launch`` a part,
or the plain route), and a part's first run joins the previous part's
last one where the keys at the boundary are equal (``key_eq`` of them
where one is given): its total is folded into that run's (``op``, in
part order) and, without ``key_eq``, the run reports the later part's
tail key.  A run may span whole parts and chain.  Every part's count and
every boundary's join reach the host in one sync, as the one-part path's
count does.  The results are vectors of the context, partitioned by its
points for their length, each part filled by device copies from the
parts that hold its runs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..vector import vector
from .cuda_by_key import reduce_by_key_apply, reduce_by_key_launch
from .cuda_compact import compact_apply
from .monoid import monoid_of
from .scan_by_key import _key_tensors, seg_scan, segment_flags

__all__ = ["reduce_by_key"]


def _fill(dst: Optional[vector], t: torch.Tensor, ctx) -> vector:
    """dst (or a new vector) holding t: t itself where the types agree
    (the results are new tensors), else a copy in dst's type."""
    if dst is None:
        return vector._adopt(t, ctx)
    if dst.dtype == t.dtype and dst.context.device == t.device:
        dst._t = t
    else:
        dst._set_storage(t)
    return dst


def _emit_outputs(vals_out, keys_out, okeys, ovals, multi, ctx, m):
    """Fill (or create) the output containers (reduce_by_key.py:102-116)."""
    ovals = _fill(ovals, vals_out, ctx)
    if okeys is None:
        okeys_out = [_fill(None, k, ctx) for k in keys_out]
    else:
        okeys_out = list(okeys) if isinstance(okeys, (tuple, list)) else [okeys]
        for dst, k in zip(okeys_out, keys_out):
            _fill(dst, k, ctx)
    if not multi:
        return okeys_out[0], ovals, m
    return tuple(okeys_out), ovals, m


def reduce_by_key(
    keys: Union[vector, Sequence[vector]],
    vals: vector,
    okeys: Optional[Union[vector, Sequence[vector]]] = None,
    ovals: Optional[vector] = None,
    op: Optional[Callable] = None,
    op_name: Optional[str] = None,
    key_eq: Optional[Callable] = None,
) -> Tuple:
    """Reduce runs of equal (tuples of) keys; returns (okeys, ovals, count).

    If ``okeys``/``ovals`` containers are passed they are resized and filled
    (reference calling convention, reduce_by_key.hpp:435); otherwise new
    vectors are returned.
    """
    multi = isinstance(keys, (tuple, list))
    kv = tuple(keys) if multi else (keys,)
    mono, op = monoid_of(op, op_name)
    if any(getattr(v, "nparts", 1) > 1 for v in (vals, *kv)):
        return _reduce_parts(kv, vals, okeys, ovals, multi, mono, op, key_eq)
    x = vals.storage
    if mono is not None and key_eq is None:
        m, vals_c, keys_c = reduce_by_key_apply(_key_tensors(keys), x, mono)
        return _emit_outputs(vals_c, keys_c, okeys, ovals, multi,
                             vals.context, m)
    heads, ks = segment_flags(keys, key_eq)
    if x.shape[0] == 0:
        return _emit_outputs(x.clone(), [k.clone() for k in ks], okeys,
                             ovals, multi, vals.context, 0)
    tails = torch.cat([heads[1:], heads.new_ones(1)])
    incl = seg_scan(heads, x, mono, op)
    if key_eq is None:
        count, vals_c, *keys_c = compact_apply(tails, incl, *ks)
    else:
        count, vals_c = compact_apply(tails, incl)
        keys_c = compact_apply(heads, *ks)[1:]
    m = int(count)          # the one host sync (the reference resizes too)
    return _emit_outputs(vals_c[:m], [k[:m] for k in keys_c], okeys, ovals,
                         multi, vals.context, m)


def _fill_parts(dst: Optional[vector], parts, pts, ctx) -> vector:
    """dst (or a new vector of ``ctx``) holding the part tensors ``parts``
    split at ``pts``, in dst's type."""
    if dst is None:
        return vector._from_parts(ctx, pts, parts)
    if list(dst.context.devices) != list(ctx.devices):
        raise ValueError("reduce_by_key over parts fills output vectors of "
                         "the inputs' context")
    dt = dst.dtype
    dst._t, dst._pts = None, pts
    dst._parts = [p.to(dt) for p in parts]
    return dst


def _reduce_parts(kv, vals: vector, okeys, ovals, multi: bool, mono, op,
                  key_eq):
    """reduce_by_key over the parts of partitioned vectors (see the
    module docstring)."""
    from ..expr.compile import _same_partition
    from ..parallel.halo import window
    from ..vector import partition
    from .cuda_scan import _OPS

    for k in kv:
        if not isinstance(k, vector):
            raise TypeError("reduce_by_key over parts takes key vectors")
        _same_partition(k, vals)
    ctx, pts = vals.context, vals._pts
    nz = [int(d) for d in np.flatnonzero(np.diff(pts))]
    fn = op if mono is None else _OPS[mono]
    outs = []               # (count, totals, [tail keys]) a part
    for d in nz:
        ks = [k._parts[d] for k in kv]
        x = vals._parts[d]
        if mono is not None and key_eq is None:
            count, totals, *kout = reduce_by_key_launch(ks, x, mono)
        else:
            heads, _ = segment_flags(tuple(ks), key_eq)
            tails = torch.cat([heads[1:], heads.new_ones(1)])
            incl = seg_scan(heads, x, mono, op)
            if key_eq is None:
                count, totals, *kout = compact_apply(tails, incl, *ks)
            else:
                count, totals = compact_apply(tails, incl)
                kout = list(compact_apply(heads, *ks)[1:])
        outs.append((count, totals, kout))
    first = vals._parts[nz[0]].device if nz else ctx.devices[0]
    # which boundaries join two runs, from the input keys around them
    if len(nz) > 1:
        firsts = [torch.cat([k._parts[d][:1].to(first) for d in nz[1:]])
                  for k in kv]
        lasts = [torch.cat([k._parts[d][-1:].to(first) for d in nz[:-1]])
                 for k in kv]
        if key_eq is None:
            join = torch.ones(len(nz) - 1, dtype=torch.bool, device=first)
            for f, la in zip(firsts, lasts):
                join &= f == la
        else:
            join = torch.as_tensor(key_eq(*lasts, *firsts),
                                   dtype=torch.bool, device=first)
    else:
        join = torch.zeros(0, dtype=torch.bool, device=first)
    # the one host sync: every count and every join
    host = torch.cat([*(c.to(first, torch.int64).reshape(1)
                        for c, _, _ in outs),
                      join.to(torch.int64)]).tolist()
    counts, joins = host[:len(nz)], host[len(nz):]
    segs, owner = [], None
    for j, (_, totals, kout) in enumerate(outs):
        lo = 0
        if j and joins[j - 1]:
            # the run at the boundary continues the owner's run
            oj, oi = owner
            ot, ok = outs[oj][1], outs[oj][2]
            dev = ot.device
            ot[oi:oi + 1] = fn(ot[oi:oi + 1], totals[:1].to(dev))
            if key_eq is None:
                for a, b in zip(ok, kout):
                    a[oi:oi + 1] = b[:1].to(dev)
            lo = 1
        if counts[j] > lo:
            segs.append((j, lo, counts[j]))
            owner = (j, counts[j] - 1)
    m = int(sum(hi - lo for _, lo, hi in segs))
    vpts = np.concatenate([[0], np.cumsum([hi - lo for _, lo, hi in segs])])
    opts = partition(m, ctx)

    def spread(cols, dt):
        """The output parts of one column (a tensor a source part)."""
        pieces = [cols[j][lo:hi] for j, lo, hi in segs]
        return [window(pieces, vpts, int(a), int(b), dev) if b > a else
                torch.empty(0, dtype=dt, device=dev)
                for a, b, dev in zip(opts[:-1], opts[1:], ctx.devices)]

    ovals = _fill_parts(ovals, spread([o[1] for o in outs], vals.dtype),
                        opts, ctx)
    okeys_in = ([None] * len(kv) if okeys is None else
                list(okeys) if isinstance(okeys, (tuple, list)) else [okeys])
    okeys_out = [
        _fill_parts(dst, spread([o[2][q] for o in outs], kv[q].dtype), opts,
                    ctx)
        for q, dst in enumerate(okeys_in)]
    if not multi:
        return okeys_out[0], ovals, m
    return tuple(okeys_out), ovals, m
