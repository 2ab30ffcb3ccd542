"""sort / sort_by_key.

Port of ``vexcl_tpu/ops/sort.py`` (vexcl/sort.hpp:427-2186).  The JAX
package sorts with ``jax.lax.sort`` outside any Pallas kernel, so the
port sorts with PyTorch's stable sort: a tuple of keys sorts
lexicographically as successive stable sorts, least significant key
first, each permuting an index vector; the keys and values are gathered
once at the end.  Orderings: ascending (default), ``descending``, and a
comparator given as a key transform ``key_fn(*keys)``, returning one key
or a tuple of them (the reference's "even first" is ``lambda k: (k & 1,
k)``).  ``descending`` maps each sort key to one of reversed order as the
JAX package does (``~k`` for integers, ``-k`` for floats) and sorts
ascending, so NaN sorts last either way.  Unsigned keys sort through an
order-preserving int64 view and move as signed bits.  Vectors of a
context of several parts sort by odd-even block merge-split
(``ops/sort_dist.py``), bit for bit the one-part sort.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..vector import vector

__all__ = ["sort", "sort_by_key"]

_UNSIGNED = (torch.uint16, torch.uint32)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def _as_tuple(v) -> Tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def _sortable(k: torch.Tensor) -> torch.Tensor:
    """A key of the same order that torch sorts on every device."""
    if k.dtype == torch.bool:
        return k.to(torch.uint8)
    if k.dtype in _UNSIGNED:
        return k.to(torch.int64)
    if k.dtype == torch.uint64:
        # flip the top bit of the bits: an order-preserving int64 view
        return k.view(torch.int64) ^ torch.iinfo(torch.int64).min
    return k


def _neg_order(k: torch.Tensor) -> torch.Tensor:
    """A key of reversed order (``~k`` cannot overflow at INT_MIN)."""
    return -k if k.is_floating_point() else ~k


def _sort_keys(ks: Sequence[torch.Tensor], descending: bool,
               key_fn: Optional[Callable]) -> List[torch.Tensor]:
    """The keys that sort ascending in the order asked for: ``key_fn``'s
    transform, made sortable, each reversed where ``descending``."""
    if key_fn is not None:
        skeys = _as_tuple(key_fn(*ks))
    else:
        skeys = tuple(ks)
    skeys = [_sortable(torch.as_tensor(k, device=ks[0].device))
             for k in skeys]
    if descending:
        skeys = [_neg_order(k) for k in skeys]
    return skeys


def _perm(skeys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable lexicographic sorting permutation of ``skeys``."""
    perm = None
    for k in reversed(skeys):
        kk = k if perm is None else k[perm]
        idx = torch.sort(kk, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def _signed(t: torch.Tensor) -> torch.Tensor:
    """CUDA gathers no unsigned type: the bits as signed ones."""
    return t.view(_SIGNED.get(t.dtype, t.dtype))


def _sort_vectors(ks, vs, descending, key_fn) -> None:
    if ks[0].size == 0:
        return
    if any(v.nparts > 1 for v in (*ks, *vs)):
        from .sort_dist import sort_parts

        sort_parts(ks, vs, descending, key_fn)
        return
    perm = _perm(_sort_keys([k.storage for k in ks], descending, key_fn))
    for v in (*ks, *vs):
        t = _signed(v.storage)
        t.copy_(t[perm])


def sort(keys: Union[vector, Sequence[vector]], descending: bool = False,
         key_fn: Optional[Callable] = None) -> None:
    """In-place sort of one vector or a tuple of key vectors
    (vex::sort, sort.hpp:2157-2169)."""
    _sort_vectors(_as_tuple(keys), (), descending, key_fn)


def sort_by_key(keys: Union[vector, Sequence[vector]],
                vals: Union[vector, Sequence[vector]],
                descending: bool = False,
                key_fn: Optional[Callable] = None) -> None:
    """In-place key-value sort (vex::sort_by_key, sort.hpp:2171-2183)."""
    _sort_vectors(_as_tuple(keys), _as_tuple(vals), descending, key_fn)
