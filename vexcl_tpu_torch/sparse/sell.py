"""SELLR: the irregular-matrix format, as SELL-C-sigma with C = 32.

Takes the role of ``vexcl_tpu/sparse/shuffle.py::SELLR`` (:921-1541),
the JAX package's default format for irregular matrices on an
accelerator; the port's CUDA default is CSR, which is faster on the
H100 (``spmat.py``), and SELLR is kept on request (``fmt="sellr"``).
Its TPU design sorts rows by length into width classes (``_length_classes``
:1624, ``_choose_classes`` :1659) and moves every entry through Benes
shuffle routes, because a TPU has no fast gather.  The H100 has one, so
the port keeps the sort and drops the routes:

* rows are sorted by length, longest first, inside windows of ``SIGMA``
  consecutive rows (the sigma of SELL-C-sigma, the role of the width
  classes); each slice of 32 sorted rows is as wide as its longest row,
  rounded up to a multiple of 4 (the SELL kernel's 16-byte packets);
* ``perm`` gives each sorted row its natural row, and the SELL kernel
  writes y there once: no y route, no atomics;
* rows longer than ``LONG_ROW`` entries leave the slices for a CSR tail
  that the CSR kernel adds onto y, as the JAX format spills to its CSR
  tail (shuffle.py:1535-1536): no slice is wider than that, so no warp
  carries a row many times the mean.

Not ported, because they exist only for the TPU's lack of a gather: the
hot-column dense plane (:935-937) and the balanced source layout
(``_balance_layout`` :1543); L2 serves the reused columns.  JAX's SELLR
state is a Benes route plan, which has no counterpart in a gather
layout, so the port builds SELLR from the same host CSR and the tests
compare results.  Unlike the JAX planner it is not int32-bounded in nnz
(slot offsets are int64); n and m stay below 2^31.
"""

from __future__ import annotations

import numpy as np

from .formats import SlicedEll, check_csr

__all__ = ["SELLR", "SIGMA", "LONG_ROW", "sigma_order"]

#: rows sorted together.  On the lognormal bench matrix (2^20 rows, mean
#: 16) slices of sorted rows pad the slots by 1.7% at 16384 rows, 6.4%
#: at 4096 and 320% unsorted; a window keeps rows that are near each other
#: (and so, in a mesh matrix, their columns) near each other.
SIGMA = 16384

#: rows with more entries go to the CSR kernel, where a row block's
#: threads share them (a row of over ``ROW_BLOCK_ENTRIES / 2`` entries
#: takes a whole block) and one SELL thread would carry the row alone.
#: On the bench matrix (mean 16) a spill at 64 sends 1.6% of the rows and
#: 9% of the entries to the CSR kernel and leaves 0.8% padding; SELLR's
#: product ran faster at 64 than at 128 or 256 on the H100, and 2-3%
#: faster still at 32, where a third of the entries spill to the CSR
#: kernel (``chip_smoke.py --spills 32 128 256``; PERF.md).
LONG_ROW = 64


def sigma_order(lens: np.ndarray) -> np.ndarray:
    """Rows sorted by ``lens``, longest first, inside windows of
    ``SIGMA`` rows; equal lengths keep their order."""
    n = len(lens)
    top = int(lens.max(initial=0))
    window = np.arange(n, dtype=np.int64) // SIGMA
    return np.argsort(window * (top + 1) + (top - lens), kind="stable")


class SELLR(SlicedEll):
    """Irregular sparse matrix in SELL-32-sigma slices (see module doc)."""

    format = "sellr"

    def __init__(self, n: int, m: int, ptr, col, val, *, device=None):
        ptr, col, val = check_csr(n, m, ptr, col, val)
        lens = np.diff(ptr)
        lens = np.where(lens > LONG_ROW, 0, lens)
        self._pack(n, m, ptr, col, val, lens, sigma_order(lens), None,
                   device)
