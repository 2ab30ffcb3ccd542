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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..vector import vector
from .cuda_by_key import reduce_by_key_apply
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
    mono, op = monoid_of(op, op_name)
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
