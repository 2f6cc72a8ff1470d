"""Incomplete QR preconditioner for rectangular least-squares problems
(counterpart of ``stormx/precond/iqr.py``).

The CIMGS equivalence (Wang, Gallivan & Bramley, SISC 18(2), 1997): the R
factor of an incomplete modified-Gram-Schmidt QR of A equals the incomplete
Cholesky factor of the normal-equations matrix AᵀA on the same pattern.

* host: form B = AᵀA sparsely, run IC(0) on it → B ≈ RᵀR with R upper
  triangular (the JAX package's own Python, so the factor is bit for bit
  its factor);
* device: R is a *right* preconditioner for :func:`stormx_torch.solvers.lsqr`
  / :func:`lsmr` — they solve min‖A R⁻¹ y − b‖, whose normal-equations
  matrix R⁻ᵀ(AᵀA)R⁻¹ ≈ I, then x = R⁻¹ y.

The apply is one sparse triangular solve (level-scheduled exact, or fixed
Jacobi sweeps), and the adjoint apply (LSQR's 𝓐* chain) the transposed one.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.precond.factorized import ic0_factorize
from stormx_torch.precond.triangular import build_triangular, tri_solve
from stormx_torch.solvers.preconditioner import Preconditioner
from stormx_torch.sparse.formats import dtype_of, host

__all__ = ["IqrPreconditioner", "normal_equations_csr"]


def normal_equations_csr(row_ptr, cols, vals, n_rows, n_cols):
    """Host-side sparse B = AᵀA from CSR triples of A (exact pattern)."""
    # Every row r of A adds the outer product of its entries to B.
    acc: list[dict] = [dict() for _ in range(n_cols)]
    for r in range(n_rows):
        lo, hi = row_ptr[r], row_ptr[r + 1]
        idx = cols[lo:hi]
        v = vals[lo:hi]
        for a in range(len(idx)):
            ia = int(idx[a])
            va = v[a]
            row = acc[ia]
            for b in range(len(idx)):
                jb = int(idx[b])
                row[jb] = row.get(jb, 0.0) + va * v[b]
    b_ptr = np.zeros(n_cols + 1, dtype=np.int64)
    b_cols, b_vals = [], []
    for i in range(n_cols):
        for j in sorted(acc[i]):
            b_cols.append(j)
            b_vals.append(acc[i][j])
        b_ptr[i + 1] = len(b_cols)
    return b_ptr, np.asarray(b_cols, dtype=np.int32), np.asarray(b_vals)


class IqrPreconditioner(Preconditioner):
    """Incomplete QR (CIMGS): right preconditioner M = R⁻¹ for LSQR/LSMR on
    rectangular A.

    ``matrix`` is the CSR of A (rectangular allowed).  ``shift`` adds
    α·diag(B) before the incomplete Cholesky when B = AᵀA is not strongly
    diagonally dominant.  ``dtype`` (a torch dtype, by default the
    matrix's) and ``device`` (the card unless the caller asks for the CPU)
    place the two triangular factors.
    """

    def __init__(self, matrix, *, shift: float = 0.0, sweeps: int | None = None,
                 dtype: torch.dtype | None = None, device="cuda"):
        self._sweeps = sweeps
        dev = resolve_device(device)
        row_ptr = host(matrix.row_ptr)
        cols = host(matrix.indices)
        vals = host(matrix.data).astype(np.float64)
        n_rows, n_cols = matrix.shape
        b_ptr, b_cols, b_vals = normal_equations_csr(row_ptr, cols, vals, n_rows, n_cols)
        if shift:
            for i in range(n_cols):
                for k in range(b_ptr[i], b_ptr[i + 1]):
                    if b_cols[k] == i:
                        b_vals[k] *= 1.0 + shift
        l_cols, l_vals = ic0_factorize(b_ptr, b_cols, b_vals, n_cols)
        host_dtype = host(matrix.data).dtype
        dtype = dtype or dtype_of(host(matrix.data))
        # R = Lᵀ (upper, incl. diag) and L itself for the adjoint solve.
        lo_ptr = np.zeros(n_cols + 1, dtype=np.int64)
        lo_c, lo_v = [], []
        for i in range(n_cols):
            order = np.argsort(l_cols[i])
            lo_c.extend(np.asarray(l_cols[i])[order])
            lo_v.extend(np.asarray(l_vals[i])[order])
            lo_ptr[i + 1] = len(lo_c)
        lo_c = np.asarray(lo_c, dtype=np.int32)
        lo_v = np.asarray(lo_v, dtype=host_dtype)
        rows_of = np.repeat(np.arange(n_cols), np.diff(lo_ptr))
        order = np.lexsort((rows_of, lo_c))
        up_ptr = np.zeros(n_cols + 1, dtype=np.int64)
        np.add.at(up_ptr, lo_c.astype(np.int64) + 1, 1)
        self._r = build_triangular(  # R (upper)
            np.cumsum(up_ptr), rows_of[order].astype(np.int32), lo_v[order],
            n_cols, lower=False, device=dev,
        ).astype(dtype)
        self._rt = build_triangular(lo_ptr, lo_c, lo_v, n_cols, lower=True,
                                    device=dev).astype(dtype)

    def __call__(self, y):
        """x = R⁻¹ y (upper solve)."""
        return tri_solve(self._r, y, sweeps=self._sweeps)

    def conj_apply(self, y):
        """R⁻ᵀ y (lower solve) — the adjoint of the apply."""
        return tri_solve(self._rt, y, sweeps=self._sweeps)
