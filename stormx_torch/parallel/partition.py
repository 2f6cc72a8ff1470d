"""Bandwidth-reducing orderings (the ordering part of
``stormx/parallel/partition.py:44-137``; partitioning waits for the
distributed slice).

RCM runs in the port's native host runtime (``stormx_torch._native``) with a
pure-NumPy fallback; both give the permutation of the JAX package bit for
bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rcm_order", "bandwidth_order"]


def _csr_adjacency(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetrized, deduplicated, self-loop-free CSR adjacency (vectorized)."""
    rows = np.concatenate([rows, cols])
    cols_sym = np.concatenate([cols, rows[: len(cols)]])
    mask = rows != cols_sym
    r, c = rows[mask], cols_sym[mask]
    order_rc = np.lexsort((c, r))
    r, c = r[order_rc], c[order_rc]
    keep = np.ones(len(r), dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    r, c = r[keep], c[keep]
    deg = np.bincount(r, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    return ptr, c.astype(np.int64), deg


def _rcm_python(n: int, ptr: np.ndarray, c: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """Pure-NumPy RCM BFS (fallback when the native library is unavailable)."""
    visited = np.zeros(n, dtype=bool)
    result = np.empty(n, dtype=np.int64)
    pos = 0
    order_by_degree = np.argsort(deg, kind="stable")
    for seed in order_by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        result[pos] = seed
        pos += 1
        head = pos - 1
        while head < pos:
            u = result[head]
            head += 1
            nbrs = c[ptr[u] : ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                result[pos : pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return result[::-1].copy()


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee ordering from an edge list (symmetrized).

    Returns ``order`` with ``order[new] = old``.
    """
    ptr, c, deg = _csr_adjacency(n, np.asarray(rows), np.asarray(cols))
    from stormx_torch._native import native_rcm_order

    out = native_rcm_order(ptr, c)
    if out is not None:
        return out
    return _rcm_python(n, ptr, c, deg)


def bandwidth_order(
    n: int, rows: np.ndarray, cols: np.ndarray, coords: np.ndarray | None = None
) -> np.ndarray:
    """Minimum-bandwidth ordering: best of RCM and (when cell ``coords`` are
    given) lexicographic coordinate sorts along each axis.  Returns
    ``order[new] = old``.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)

    def bw(perm):
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        d = inv[cols] - inv[rows]
        return int(-d.min(initial=0)) + int(d.max(initial=0))

    candidates = [rcm_order(n, rows, cols)]
    if coords is not None:
        coords = np.asarray(coords)
        span = coords.max(axis=0) - coords.min(axis=0)
        eps = 1e-9 * (span.max() + 1.0)
        for ax in range(coords.shape[1]):
            others = [a for a in range(coords.shape[1]) if a != ax]
            key = coords[:, ax].copy()
            for o in others:
                key = key + eps * coords[:, o]
            candidates.append(np.argsort(key, kind="stable").astype(np.int64))
    widths = [bw(p) for p in candidates]
    return candidates[int(np.argmin(widths))]
