"""Sort over the parts of a partitioned vector: odd-even block merge-split.

Port of ``vexcl_tpu/ops/sort_dist.py:53-131``.  Each part sorts its own
block with ``sort.py``'s stable sort; then come rounds of neighbour pairs,
(0, 1), (2, 3), ... in even rounds and (1, 2), (3, 4), ... in odd ones:
a pair merges its two blocks, the lower block keeps the lowest elements
and the upper one the rest.  The JAX package sorts with ``lax.sort``
outside any Pallas kernel, so the local sort and the merge are PyTorch's
stable sort (``sort._perm``) here as on one part.

* Keys.  The sort keys are ``sort._sort_keys``'s (``key_fn``'s transform,
  made sortable, reversed where ``descending``), computed once a part;
  the original keys and values travel as payload, as signed bits.
* Stability.  The JAX package puts a global-index tiebreak last among its
  keys because its merges are not stable.  Here every merge is a stable
  sort of two neighbouring blocks in their order, so equal keys keep the
  order they had in the whole vector, from the local sorts on: the
  global-index order is implied, and the result is the one-part stable
  sort bit for bit (``tests/test_torch_multidevice_algorithms.py`` holds
  it with ties, NaN, ``descending`` and ``key_fn``).
* Uneven and empty parts.  The JAX package takes only equal, unpadded
  shards, and D rounds sort D equal blocks.  With blocks of other sizes D
  rounds do not suffice (blocks of 3, 1 and 4 elements need 8).  So the
  merge-split runs over the D' non-empty parts as blocks of one capacity,
  the largest part's size M, filled as far as the data goes: a merge's
  lower block keeps min(M, both fills) elements.  That is the equal-block
  network over D' x M elements with the missing ones past every key,
  which D' rounds sort; the fills follow from the part sizes alone, so the
  host never waits for the device.  After the rounds block k holds the
  ranks [k M, k M + fill); where the partition is not the blocks' (uneven
  parts), each part copies its own ranks from the blocks that hold them
  (``parallel.halo.window``).  The hypothesis test of every 0-1 input of
  up to 12 elements over random uneven partitions of up to 5 parts holds
  the network (the 0-1 principle: a network of merges that sorts every
  0-1 input sorts every input).
* Devices.  A pair merges on the lower block's device: the upper block
  moves there with one ``.to(device)`` a column, and its new contents
  move back with one more.  Nothing in a round waits for the device.

``sort_parts.merges`` counts the merges of two non-empty blocks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.halo import window
from .sort import _perm, _signed, _sort_keys

__all__ = ["sort_parts", "merge_schedule"]


def _merge_split(a: List[torch.Tensor], b: List[torch.Tensor],
                 keys: Sequence[int], keep: int):
    """Columns of blocks a and b (each sorted by the columns ``keys``)
    merged on a's device: the lowest ``keep`` elements, and the rest on
    b's device."""
    dev_a, dev_b = a[0].device, b[0].device
    both = [torch.cat([ca, cb.to(dev_a, non_blocking=True)])
            for ca, cb in zip(a, b)]
    if a[0].numel() and b[0].numel():
        perm = _perm([both[i] for i in keys])
        both = [c[perm] for c in both]
        sort_parts.merges += 1
    return ([c[:keep] for c in both],
            [c[keep:].to(dev_b, non_blocking=True) for c in both])


def merge_schedule(fills: List[int]):
    """The merges of the rounds over blocks of these fills, in order:
    (i, keep) merges blocks i and i + 1, the lower keeping ``keep``
    elements.  The capacity is the largest fill; ``fills`` is updated to
    the blocks' fills after each merge."""
    cap = max(fills, default=0)
    for t in range(len(fills)):
        for i in range(t % 2, len(fills) - 1, 2):
            total = fills[i] + fills[i + 1]
            if fills[i + 1] == 0:
                continue        # the lower block keeps what it has
            keep = min(cap, total)
            fills[i], fills[i + 1] = keep, total - keep
            yield i, keep


def sort_parts(ks: Sequence, vs: Sequence, descending: bool,
               key_fn: Optional[Callable]) -> None:
    """Sort the partitioned key vectors ``ks`` and carry the value vectors
    ``vs`` with them, in place (see the module docstring)."""
    from ..expr.compile import _same_partition

    vecs = (*ks, *vs)
    ref = ks[0]
    for v in vecs:
        _same_partition(v, ref)
    pts = ref._pts
    sizes = np.diff(pts)
    nz = [int(d) for d in np.flatnonzero(sizes)]
    nk = len(ks)
    blocks, keys = [], None
    for d in nz:
        raw = [v._parts[d] for v in vecs]
        cols = [_signed(t) for t in raw]
        skeys = _sort_keys(raw[:nk], descending, key_fn)
        # a key that sorts as it is sorts as its payload column
        keys = []
        for s in skeys:
            j = next((i for i in range(nk) if s is raw[i]), None)
            if j is None:
                cols.append(s)
                j = len(cols) - 1
            keys.append(j)
        perm = _perm([cols[i] for i in keys])
        blocks.append([c[perm] for c in cols])
    fills = [int(sizes[d]) for d in nz]
    for i, keep in merge_schedule(fills):
        blocks[i], blocks[i + 1] = _merge_split(blocks[i], blocks[i + 1],
                                                keys, keep)
    vpts = np.concatenate([[0], np.cumsum(fills)])
    aligned = np.array_equal(vpts, pts[[0, *[d + 1 for d in nz]]])
    for k, d in enumerate(nz):
        for j, v in enumerate(vecs):
            if aligned:
                src = blocks[k][j]
            else:
                src = window([b[j] for b in blocks], vpts, int(pts[d]),
                             int(pts[d + 1]), v._parts[d].device)
            _signed(v._parts[d]).copy_(src)


#: merges of two non-empty blocks (each a stable sort of both)
sort_parts.merges = 0
