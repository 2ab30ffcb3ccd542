"""Segmented (by-key) scan.

Port of ``vexcl_tpu/ops/scan_by_key.py`` (vexcl/scan_by_key.hpp:67-757).
A segment is a run of equal keys: one key vector or a tuple of them (the
reference's fusion-tuple keys), or runs under a custom ``key_eq(*left,
*right)`` predicate over neighbouring key values.  The three standard
monoids without ``key_eq`` are one launch of the keyed kernel of
``cuda_by_key.py``, which computes the head flags from the keys and
folds the exclusive shift and ``init`` in itself (on the CPU, its plain
version).  A Python ``key_eq`` or a custom ``op`` cannot enter a CUDA
kernel: there the head flags come from one plain tensor comparison
(``segment_flags``), as the JAX package derives them in XLA, a standard
monoid runs the segmented scan kernel of ``cuda_scan.py`` and a custom
``op`` the pair monoid

    (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : op(v1, v2))

through ``associative_scan``, and the epilogue is tensor code.  Exclusive
scans give each head ``init`` (0 without one) and every other position
``op(init, previous inclusive value)``, as the JAX package's generic
path does.  Over the parts of partitioned vectors the scan is the JAX
package's three-phase pair scan (``parallel.collectives.
distributed_scan_by_key``): the same local kernel (or plain route) a part,
the carries of the parts' tail pairs, one fix-up launch a part.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from ..vector import host_tensor, vector
from .cuda_by_key import (scan_by_key_apply, scan_by_key_epilogue,
                          segment_heads)
from .cuda_scan import associative_scan, segscan_apply
from .monoid import monoid_of

__all__ = ["inclusive_scan_by_key", "exclusive_scan_by_key",
           "segment_flags"]


def _key_tensors(keys) -> Tuple[torch.Tensor, ...]:
    ks = keys if isinstance(keys, (tuple, list)) else (keys,)
    return tuple(k.storage if isinstance(k, vector) else host_tensor(k)
                 for k in ks)


def segment_flags(keys, key_eq: Optional[Callable] = None):
    """(flags, key tensors): flags[i] is True where element i starts a
    new segment."""
    ks = _key_tensors(keys)
    if key_eq is None:
        return segment_heads(ks), ks
    n = ks[0].shape[0]
    eq = torch.as_tensor(key_eq(*[k[:-1] for k in ks], *[k[1:] for k in ks]),
                         dtype=torch.bool)
    head = torch.ones(min(n, 1), dtype=torch.bool, device=ks[0].device)
    return torch.cat([head, ~eq.to(head.device)]), ks


def seg_scan(flags: torch.Tensor, x: torch.Tensor, mono: Optional[str],
             op: Optional[Callable]) -> torch.Tensor:
    """Segmented inclusive scan of ``x`` from head ``flags``: the kernel
    for a standard monoid, ``associative_scan`` for a custom ``op``."""
    if mono is not None:
        return segscan_apply(flags, x, mono)

    def combine(a, b):
        (fa, va), (fb, vb) = a, b
        return fa | fb, torch.where(fb, vb, op(va, vb))

    return associative_scan(combine, (flags, x))[1]


def _run(keys, src: vector, dst: Optional[vector], op, op_name, key_eq,
         exclusive: bool, init) -> vector:
    kv = tuple(keys) if isinstance(keys, (tuple, list)) else (keys,)
    mono, op = monoid_of(op, op_name)
    if any(getattr(v, "nparts", 1) > 1 for v in (src, dst, *kv)):
        from ..parallel.collectives import distributed_scan_by_key

        if not all(isinstance(k, vector) for k in kv):
            raise TypeError("scan_by_key over parts takes key vectors")
        return distributed_scan_by_key(kv, src, dst, mono, op, key_eq,
                                       exclusive, init)
    x = src.storage
    if mono is not None and key_eq is None:
        ks = _key_tensors(keys)
        # into dst's storage where it is like x and no key (x itself may
        # be it); else into a new tensor, which dst adopts or copies
        direct = (dst is not None and dst.dtype == x.dtype
                  and dst.size == src.size and not any(
                      k.untyped_storage().data_ptr()
                      == dst.storage.untyped_storage().data_ptr()
                      for k in ks))
        out = scan_by_key_apply(ks, x, mono, exclusive, init,
                                out=dst.storage if direct else None)
        if dst is None:
            return vector._adopt(out, src.context)
        if not direct:
            dst._set_storage(out)
        return dst
    flags, _ = segment_flags(keys, key_eq)
    if dst is None:
        dst = vector(src.size, dtype=src.dtype, context=src.context)
    if x.shape[0] == 0:
        return dst
    incl = seg_scan(flags, x, mono, op)
    dst._set_storage(scan_by_key_epilogue(flags, incl, op or torch.add,
                                          exclusive, init))
    return dst


def inclusive_scan_by_key(
    keys: Union[vector, Sequence[vector]], src: vector,
    dst: Optional[vector] = None, init: Any = None,
    op: Optional[Callable] = None, op_name: Optional[str] = None,
    key_eq: Optional[Callable] = None,
) -> vector:
    """vex::inclusive_scan_by_key (scan_by_key.hpp:724-741)."""
    return _run(keys, src, dst, op, op_name, key_eq, exclusive=False,
                init=init)


def exclusive_scan_by_key(
    keys: Union[vector, Sequence[vector]], src: vector,
    dst: Optional[vector] = None, init: Any = None,
    op: Optional[Callable] = None, op_name: Optional[str] = None,
    key_eq: Optional[Callable] = None,
) -> vector:
    """vex::exclusive_scan_by_key (scan_by_key.hpp:743-757)."""
    return _run(keys, src, dst, op, op_name, key_eq, exclusive=True,
                init=init)
