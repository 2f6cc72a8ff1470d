"""Sparse triangular solves (counterpart of ``stormx/precond/triangular.py``).

Two formulations over one frozen :class:`TriangularFactor`:

* **Level scheduling** (exact).  On the host, the dependency depth of every
  row (longest path in the triangular DAG); rows of equal depth form a
  *level* and are independent, so the device loops over levels with one
  padded gather + FMA + scatter per level.  Exact to roundoff; it costs
  ``num_levels`` sequential steps of a few launches each, and mesh
  operators of 10⁵ rows have 10³ levels.
* **Jacobi sweeps** (approximate).  ``y ← D⁻¹(r − N·y)`` for a fixed number
  of sweeps — a truncated Neumann series for ``(D+N)⁻¹``, one ELL product per
  sweep; ``sweeps ≥ num_levels`` reproduces the exact solve.  A fixed sweep
  count keeps the apply linear, so CG stays safe with a symmetrized pair.

The JAX package runs both as ``lax.fori_loop``s; here they are Python loops
over host integers that never read the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stormx_torch.core.config import resolve_device

__all__ = ["TriangularFactor", "build_triangular", "tri_solve"]


class TriangularFactor(NamedTuple):
    """Device form of a sparse triangular matrix ``T = D + N`` (``N``
    strictly triangular), ready for :func:`tri_solve`.

    All row-indexed tensors carry one padding row ``n`` (a write dump for
    the level scatter); ELL value padding is zero, so padded columns add
    nothing, and ``inv_diag[n] = 0`` makes every write to the dump row a
    zero.  Index tensors are int64 (the JAX package's are int32).
    """

    level_rows: torch.Tensor  # (num_levels, max_level_width) int64, padded with n
    ell_cols: torch.Tensor  # (n + 1, K) int64 column ids of N
    ell_vals: torch.Tensor  # (n + 1, K) values of N; 0 on padding
    inv_diag: torch.Tensor  # (n + 1,) 1/diag(T); 0 on the padding row

    @property
    def num_rows(self) -> int:
        return self.inv_diag.shape[0] - 1

    @property
    def num_levels(self) -> int:
        return self.level_rows.shape[0]

    def astype(self, dtype: torch.dtype) -> "TriangularFactor":
        """The same factor with its values cast to ``dtype``."""
        return self._replace(ell_vals=self.ell_vals.to(dtype), inv_diag=self.inv_diag.to(dtype))


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

    # Split the strictly-triangular part from the diagonal.
    n_cols = [[] for _ in range(n)]
    n_vals = [[] for _ in range(n)]
    d = np.ones(n, dtype=dtype) if unit_diagonal else np.zeros(n, dtype=dtype)
    if diag is not None:
        d = np.asarray(diag, dtype=dtype).copy()
    for i in range(n):
        for k in range(row_ptr[i], row_ptr[i + 1]):
            j = int(cols[k])
            if j == i:
                if diag is None and not unit_diagonal:
                    d[i] = vals[k]
                continue
            if (j > i) if lower else (j < i):
                raise ValueError(
                    f"entry ({i},{j}) is on the wrong side for a "
                    f"{'lower' if lower else 'upper'} factor"
                )
            n_cols[i].append(j)
            n_vals[i].append(vals[k])
    if not unit_diagonal and np.any(d == 0):
        raise ValueError("triangular factor has zero diagonal entries")

    # Dependency depth = longest path; rows of equal depth are one level.
    depth = np.zeros(n, dtype=np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        if n_cols[i]:
            depth[i] = 1 + max(depth[j] for j in n_cols[i])
    num_levels = int(depth.max()) + 1 if n else 1
    buckets = [[] for _ in range(num_levels)]
    for i in range(n):
        buckets[int(depth[i])].append(i)
    width = max((len(b) for b in buckets), default=1)
    level_rows = np.full((num_levels, width), n, dtype=np.int64)
    for lev, b in enumerate(buckets):
        level_rows[lev, : len(b)] = b

    k_max = max(max((len(c) for c in n_cols), default=0), 1)
    ell_cols = np.zeros((n + 1, k_max), dtype=np.int64)
    ell_vals = np.zeros((n + 1, k_max), dtype=dtype)
    for i in range(n):
        cc = n_cols[i]
        ell_cols[i, : len(cc)] = cc
        ell_vals[i, : len(cc)] = n_vals[i]
    inv_diag = np.zeros(n + 1, dtype=dtype)
    inv_diag[:n] = 1.0 / d

    return TriangularFactor(
        level_rows=torch.as_tensor(level_rows, device=dev),
        ell_cols=torch.as_tensor(ell_cols, device=dev),
        ell_vals=torch.as_tensor(ell_vals, device=dev),
        inv_diag=torch.as_tensor(inv_diag, device=dev),
    )


def _off_diag_apply(tri: TriangularFactor, y_pad: torch.Tensor) -> torch.Tensor:
    """N·y for the strictly-triangular part, rows 0..n-1."""
    n = tri.num_rows
    return torch.sum(tri.ell_vals[:n] * y_pad[tri.ell_cols[:n]], dim=1)


def tri_solve(tri: TriangularFactor, r: torch.Tensor, *, sweeps: int | None = None):
    """Solve ``(D + N) y = r``.

    ``sweeps=None`` → exact level-scheduled solve; ``sweeps=k`` → k Jacobi
    sweeps of the truncated Neumann series (linear in ``r`` for fixed k).
    """
    n = tri.num_rows
    if sweeps is not None:
        inv_diag = tri.inv_diag[:n]
        y = inv_diag * r
        for _ in range(sweeps):
            contrib = _off_diag_apply(tri, torch.nn.functional.pad(y, (0, 1)))
            y = inv_diag * (r - contrib)
        return y

    r_pad = torch.nn.functional.pad(r, (0, 1))
    y = torch.zeros_like(r_pad)
    for lev in range(tri.num_levels):
        rows = tri.level_rows[lev]  # (W,) padded with n
        contrib = torch.sum(tri.ell_vals[rows] * y[tri.ell_cols[rows]], dim=1)
        y.index_copy_(0, rows, (r_pad[rows] - contrib) * tri.inv_diag[rows])
    return y[:n]
