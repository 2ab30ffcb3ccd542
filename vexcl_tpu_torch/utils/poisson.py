"""Vectorized 7-point Poisson CSR builder (the reference benchmark's
canonical SpMV workload, examples/benchmark.cpp:353-478).

The same numpy code as ``vexcl_tpu/utils/poisson.py``, with its CCSR
form."""

from __future__ import annotations

import numpy as np

__all__ = ["poisson_7pt", "poisson_7pt_ccsr"]


def poisson_7pt(n: int, dtype=np.float64):
    """CSR arrays (ptr, col, val) of the n^3 7-point Poisson matrix.

    Emitted directly in CSR order (columns of a 7-point row are already
    ascending: i-n^2 < i-n < i-1 < i < i+1 < i+n < i+n^2), so no 117M-entry
    lexsort — builds 256^3 in seconds instead of minutes."""
    N = n ** 3
    i = np.arange(N, dtype=np.int64)
    zi, zj, zk = i // (n * n), (i // n) % n, i % n
    offs = (-n * n, -n, -1, 0, 1, n, n * n)
    valid = np.empty((N, 7), dtype=bool)
    valid[:, 0] = zi > 0
    valid[:, 1] = zj > 0
    valid[:, 2] = zk > 0
    valid[:, 3] = True
    valid[:, 4] = zk < n - 1
    valid[:, 5] = zj < n - 1
    valid[:, 6] = zi < n - 1
    flat = valid.ravel()
    colmat = (i[:, None] + np.asarray(offs, dtype=np.int64)[None, :]).astype(
        np.int32)
    col = colmat.ravel()[flat]
    del colmat
    kmat = np.broadcast_to(np.arange(7, dtype=np.int8), (N, 7))
    kkept = kmat.ravel()[flat]
    val = np.where(kkept == 3, dtype(6.0), dtype(-1.0)).astype(dtype)
    ptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1, dtype=np.int64), out=ptr[1:])
    return ptr, col, val


def poisson_7pt_ccsr(n: int, dtype=np.float64):
    """CCSR form of the n^3 7-point Poisson matrix: interior/face/edge/
    corner rows share one of 27 patterns (the reference's CCSR benchmark
    workload, examples/benchmark.cpp:481-607)."""
    # classify each row by its (i, j, k) boundary signature: 0=min,1=mid,2=max
    ax = np.zeros(n, dtype=np.int64) + 1
    ax[0], ax[-1] = 0, 2
    sig = (
        ax[:, None, None] * 9 + ax[None, :, None] * 3 + ax[None, None, :]
    ).ravel()
    uniq, idx = np.unique(sig, return_inverse=True)

    ptr, col, val = [0], [], []
    offs = [
        (0, 0, 0, 6.0),
        (-1, 0, 0, -1.0), (1, 0, 0, -1.0),
        (0, -1, 0, -1.0), (0, 1, 0, -1.0),
        (0, 0, -1, -1.0), (0, 0, 1, -1.0),
    ]
    for s in uniq:
        ii, jj, kk = s // 9, (s // 3) % 3, s % 3
        # representative position for this signature
        pos = [0 if a == 0 else (n - 1 if a == 2 else 1) for a in (ii, jj, kk)]
        for (di, dj, dk, v) in offs:
            pi, pj, pk = pos[0] + di, pos[1] + dj, pos[2] + dk
            if 0 <= pi < n and 0 <= pj < n and 0 <= pk < n:
                col.append(di * n * n + dj * n + dk)  # relative offset
                val.append(v)
        ptr.append(len(col))
    return (
        idx.astype(np.int32),
        np.asarray(ptr, dtype=np.int64),
        np.asarray(col, dtype=np.int32),
        np.asarray(val, dtype=dtype),
    )


def poisson_7pt_ccsr(n: int, dtype=np.float64):
    """CCSR form of the n^3 7-point Poisson matrix: interior/face/edge/
    corner rows share one of 27 patterns (the reference's CCSR benchmark
    workload, examples/benchmark.cpp:481-607).  Returns (idx, ptr, col,
    val) of the patterns, columns relative to the row."""
    # each row's (i, j, k) boundary signature: 0 = min, 1 = mid, 2 = max
    ax = np.zeros(n, dtype=np.int64) + 1
    ax[0], ax[-1] = 0, 2
    sig = (ax[:, None, None] * 9 + ax[None, :, None] * 3
           + ax[None, None, :]).ravel()
    uniq, idx = np.unique(sig, return_inverse=True)
    ptr, col, val = [0], [], []
    offs = [(0, 0, 0, 6.0), (-1, 0, 0, -1.0), (1, 0, 0, -1.0),
            (0, -1, 0, -1.0), (0, 1, 0, -1.0), (0, 0, -1, -1.0),
            (0, 0, 1, -1.0)]
    for s in uniq:  # at most 27 patterns
        ii, jj, kk = s // 9, (s // 3) % 3, s % 3
        pos = [0 if a == 0 else (n - 1 if a == 2 else 1) for a in (ii, jj, kk)]
        for di, dj, dk, v in offs:
            pi, pj, pk = pos[0] + di, pos[1] + dj, pos[2] + dk
            if 0 <= pi < n and 0 <= pj < n and 0 <= pk < n:
                col.append(di * n * n + dj * n + dk)
                val.append(v)
        ptr.append(len(col))
    return (idx.astype(np.int32), np.asarray(ptr, dtype=np.int64),
            np.asarray(col, dtype=np.int32), np.asarray(val, dtype=dtype))
