"""Sparse triangular solves (counterpart of ``stormx/precond/triangular.py``).

Two formulations over one frozen :class:`TriangularFactor`:

* **Level scheduling** (exact).  On the host, the dependency depth of every
  row (longest path in the triangular DAG); rows of equal depth form a
  *level* and are independent.  On the card the whole solve is one launch
  of T1 (``csrc/tri_solve.cu``), in which each row waits only on its own
  dependencies; on the CPU, a loop over levels with one padded gather,
  multiply-add and scatter per level.  Exact to roundoff; mesh operators of
  10⁵ rows have 10³ levels.
* **Jacobi sweeps** (approximate).  ``y ← D⁻¹(r − N·y)`` for a fixed number
  of sweeps — a truncated Neumann series for ``(D+N)⁻¹``, one ELL product per
  sweep (one T2 launch on the card); ``sweeps ≥ num_levels`` reproduces the
  exact solve.  A fixed sweep count keeps the apply linear, so CG stays safe
  with a symmetrized pair.

The JAX package runs both as ``lax.fori_loop``s.  Both modes here add each
row's slots in slot order (:func:`stormx_torch.ops.tri_solve.slot_sum`), so
the kernels and the CPU loops agree bit for bit
(:mod:`stormx_torch.ops.tri_solve`).
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.ops import tri_solve as _kernels

__all__ = ["TriangularFactor", "build_triangular", "tri_solve", "strands"]


class TriangularFactor(NamedTuple):
    """Device form of a sparse triangular matrix ``T = D + N`` (``N``
    strictly triangular), ready for :func:`tri_solve`.

    All row-indexed tensors carry one padding row ``n`` (a write dump for
    the level scatter); ELL value padding is zero, so padded columns add
    nothing, and ``inv_diag[n] = 0`` makes every write to the dump row a
    zero.  The first four fields are the JAX factor's, bit for bit;
    ``level_rows`` is int64 (``index_copy_`` takes no other), the other
    index tensors int32 as there.  The rest serve T1, built from the same
    depths: ``row_len``, ``strand_rows`` and ``strand_ptr`` (:func:`strands`),
    and ``order``, from which T1 deals round-robin strands when a factor has
    more strands than the card holds warps at once.
    """

    level_rows: torch.Tensor  # (num_levels, max_level_width) int64, padded with n
    ell_cols: torch.Tensor  # (n + 1, K) int32 column ids of N
    ell_vals: torch.Tensor  # (n + 1, K) values of N; 0 on padding
    inv_diag: torch.Tensor  # (n + 1,) 1/diag(T); 0 on the padding row
    order: torch.Tensor  # (n,) int32, the rows level by level, ascending in each
    row_len: torch.Tensor  # (n,) int32, real entries of each row (its first slots)
    strand_rows: torch.Tensor  # (n,) int32, the rows strand by strand (strands())
    strand_ptr: torch.Tensor  # (num_strands + 1,) int32, strand s at strand_rows[ptr[s]:ptr[s+1]]

    @property
    def num_rows(self) -> int:
        return self.inv_diag.shape[0] - 1

    @property
    def num_levels(self) -> int:
        return self.level_rows.shape[0]

    def astype(self, dtype: torch.dtype) -> "TriangularFactor":
        """The same factor with its values cast to ``dtype``."""
        return self._replace(ell_vals=self.ell_vals.to(dtype), inv_diag=self.inv_diag.to(dtype))


def strands(depth: np.ndarray, ell_cols: np.ndarray, row_len: np.ndarray):
    """The rows cut into *strands*, the sequences T1 solves one warp
    each: ``(strand_rows, strand_ptr)``, int32, strand s the rows
    ``strand_rows[strand_ptr[s]:strand_ptr[s + 1]]`` in increasing depth.

    Each row takes as its link at most one of its dependencies one level
    before it, and each row is the link of at most one row (claimed slot by
    slot in slot order, the smallest reading row winning a contested one):
    the links make chains, each row of a chain at the level after the one
    before it.  A strand is chains one after another, each starting at a
    level after the one before ended (interval colouring, chains by their
    first level), so there are as many strands as the widest level has
    rows and each strand's rows lie in distinct, increasing levels.  In a
    strand a row whose link is the row before it reads that row's y from
    the group's registers, not through L2.

    ``depth`` (n,) is each row's level, ``ell_cols`` (≥ n, K) and
    ``row_len`` (n,) the factor's columns and real slots."""
    n = len(depth)
    depth = np.asarray(depth, dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(1, dtype=np.int32)
    link = np.full(n, -1, dtype=np.int64)  # the row a row reads from its own strand
    taken = np.zeros(n, dtype=bool)  # whether a row is some row's link
    for k in range(ell_cols.shape[1]):
        i = np.nonzero((np.asarray(row_len) > k) & (link < 0))[0]
        c = np.asarray(ell_cols[i, k], dtype=np.int64)
        keep = (depth[c] == depth[i] - 1) & ~taken[c]
        c, first = np.unique(c[keep], return_index=True)
        i = i[keep][first]
        link[i], taken[c] = c, True
    # Each row's chain, named by its first row (pointer doubling).
    head = np.where(link >= 0, link, np.arange(n))
    while True:
        nxt = head[head]
        if np.array_equal(nxt, head):
            break
        head = nxt
    firsts = np.nonzero(link < 0)[0]  # ascending: chain c starts at row firsts[c]
    start = depth[firsts]
    end = start + np.bincount(head, minlength=n)[firsts] - 1
    by_start = np.lexsort((firsts, start))
    strand_of = np.empty(len(firsts), dtype=np.int64)  # by chain
    ends: list[tuple[int, int]] = []  # (last level, strand) of every strand
    count = 0
    for c, s, e in zip(by_start.tolist(), start[by_start].tolist(), end[by_start].tolist()):
        if ends and ends[0][0] < s:
            strand_of[c] = ends[0][1]
            heapq.heapreplace(ends, (e, ends[0][1]))
        else:
            strand_of[c] = count
            heapq.heappush(ends, (e, count))
            count += 1
    strand = strand_of[np.searchsorted(firsts, head)]
    rows = np.lexsort((depth, strand)).astype(np.int32)
    ptr = np.zeros(count + 1, dtype=np.int32)
    np.cumsum(np.bincount(strand, minlength=count), out=ptr[1:])
    return rows, ptr


def build_triangular(row_ptr, cols, vals, n: int, *, lower: bool,
                     unit_diagonal: bool = False, diag=None, dtype=None,
                     device="cuda") -> TriangularFactor:
    """Host-side build from CSR triples of the *whole* triangle (diagonal
    included unless ``unit_diagonal`` — then ``diag`` may be omitted).

    Entries on the wrong side of the diagonal are rejected; the CSR need not
    store an explicit diagonal when ``diag`` is given separately.  ``dtype``
    is a NumPy dtype (default: the values'); the factor is placed on
    ``device``, the card unless the caller asks for the CPU.
    """
    dev = resolve_device(device)
    row_ptr = np.asarray(row_ptr)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    dtype = dtype or vals.dtype

    # Split the strictly-triangular part from the diagonal, in CSR order
    # (NumPy over all entries at once: the JAX package's row loop gives the
    # same arrays, at seconds per 10⁵ rows).
    rows = np.repeat(np.arange(n), np.diff(row_ptr[: n + 1]))
    cols = cols[row_ptr[0] : row_ptr[0] + len(rows)].astype(np.int64)
    vals = vals[row_ptr[0] : row_ptr[0] + len(rows)]
    on_diag = cols == rows
    d = np.ones(n, dtype=dtype) if unit_diagonal else np.zeros(n, dtype=dtype)
    if diag is not None:
        d = np.asarray(diag, dtype=dtype).copy()
    elif not unit_diagonal:
        d[rows[on_diag]] = vals[on_diag]
    wrong = ~on_diag & ((cols > rows) if lower else (cols < rows))
    if wrong.any():
        k = int(np.argmax(wrong))
        raise ValueError(
            f"entry ({rows[k]},{cols[k]}) is on the wrong side for a "
            f"{'lower' if lower else 'upper'} factor"
        )
    if not unit_diagonal and np.any(d == 0):
        raise ValueError("triangular factor has zero diagonal entries")
    off_rows, off_cols, off_vals = rows[~on_diag], cols[~on_diag], vals[~on_diag]
    row_len = np.bincount(off_rows, minlength=n).astype(np.int32)
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_len, out=start[1:])

    # Dependency depth = longest path; rows of equal depth are one level.
    # A row's dependencies come before it in the sweep order, so one pass.
    dep, bounds, depth = off_cols.tolist(), start.tolist(), [0] * n
    for i in range(n) if lower else range(n - 1, -1, -1):
        a, b = bounds[i], bounds[i + 1]
        if a < b:
            depth[i] = 1 + max(map(depth.__getitem__, dep[a:b]))
    depth = np.asarray(depth, dtype=np.int64)
    num_levels = int(depth.max()) + 1 if n else 1
    order = np.argsort(depth, kind="stable")  # the levels concatenated, rows ascending
    counts = np.bincount(depth, minlength=num_levels)
    level_start = np.cumsum(counts) - counts
    level_rows = np.full((num_levels, int(counts.max()) if n else 0), n, dtype=np.int64)
    level_rows[depth[order], np.arange(n) - level_start[depth[order]]] = order

    k_max = max(int(row_len.max()) if n else 0, 1)
    slot = np.arange(len(off_rows)) - start[off_rows]
    ell_cols = np.zeros((n + 1, k_max), dtype=np.int32)
    ell_vals = np.zeros((n + 1, k_max), dtype=dtype)
    ell_cols[off_rows, slot] = off_cols
    ell_vals[off_rows, slot] = off_vals
    inv_diag = np.zeros(n + 1, dtype=dtype)
    inv_diag[:n] = 1.0 / d

    strand_rows, strand_ptr = strands(depth, ell_cols, row_len)
    return TriangularFactor(
        level_rows=torch.as_tensor(level_rows, device=dev),
        ell_cols=torch.as_tensor(ell_cols, device=dev),
        ell_vals=torch.as_tensor(ell_vals, device=dev),
        inv_diag=torch.as_tensor(inv_diag, device=dev),
        order=torch.as_tensor(order.astype(np.int32), device=dev),
        row_len=torch.as_tensor(row_len, device=dev),
        strand_rows=torch.as_tensor(strand_rows, device=dev),
        strand_ptr=torch.as_tensor(strand_ptr, device=dev),
    )


def tri_solve(tri: TriangularFactor, r: torch.Tensor, *, sweeps: int | None = None):
    """Solve ``(D + N) y = r``.

    ``sweeps=None`` → exact level-scheduled solve (one T1 launch on the
    card); ``sweeps=k`` → k Jacobi sweeps of the truncated Neumann series
    (k T2 launches; linear in ``r`` for fixed k).  The kernels run for ``r``
    on the card, the plain versions for ``r`` on the CPU.
    """
    if sweeps is None:
        return _kernels.exact(tri, r)
    return _kernels.sweep(tri, r, sweeps)
