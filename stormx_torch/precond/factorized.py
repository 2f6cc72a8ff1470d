"""Incomplete-factorization preconditioners: SGS, ILU(0), IC(0) (counterpart
of ``stormx/precond/factorized.py``).

* The factorization runs **once on the host** (NumPy, or the native
  ``hostrt.cpp`` routines, over the frozen CSR), as in the JAX package, so
  the factors are bit for bit the JAX package's.
* The apply is two sparse triangular solves
  (:mod:`stormx_torch.precond.triangular`) on the factors' device — exact
  level-scheduled by default, or fixed-count Jacobi sweeps (``sweeps=k``)
  when the level DAG is deep.

Applies are linear for a fixed sweep count, so CG remains safe with the
symmetric variants (SGS, IC) on SPD operators.  Every constructor takes
``dtype`` (a torch dtype, by default the matrix's: the dtype of the vectors
the preconditioner is applied to) and ``device`` (the card unless the caller
asks for the CPU); the host work keeps the matrix's own dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core import profiling
from stormx_torch.core.config import resolve_device
from stormx_torch.precond.triangular import TriangularFactor, build_triangular, tri_solve
from stormx_torch.solvers.preconditioner import Preconditioner
from stormx_torch.sparse.formats import dtype_of, host

__all__ = [
    "SgsPreconditioner",
    "IluPreconditioner",
    "IcPreconditioner",
    "ilu0_factorize",
    "ic0_factorize",
    "ic0_factorize_csr",
]


def _csr_host(csr):
    """CSR → host NumPy triples (row_ptr, cols, vals, n)."""
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("factorized preconditioners need a square matrix")
    return host(csr.row_ptr), host(csr.indices), host(csr.data), csr.shape[0]


def _split_triangles(row_ptr, cols, vals, n):
    """(lower incl. diag, upper incl. diag, diag) as CSR triples; boolean
    masks keep CSR storage order within each row."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    cols = np.asarray(cols, dtype=np.int64)
    lm = cols <= rows
    um = cols >= rows
    lo_ptr = np.zeros(n + 1, dtype=np.int64)
    lo_ptr[1:] = np.cumsum(np.bincount(rows[lm], minlength=n))
    up_ptr = np.zeros(n + 1, dtype=np.int64)
    up_ptr[1:] = np.cumsum(np.bincount(rows[um], minlength=n))
    diag = np.zeros(n, dtype=vals.dtype)
    dm = cols == rows
    diag[rows[dm]] = vals[dm]
    return (
        (lo_ptr, cols[lm].astype(np.int32), vals[lm]),
        (up_ptr, cols[um].astype(np.int32), vals[um]),
        diag,
    )


class _TwoSolvePreconditioner(Preconditioner):
    """Shared apply: y = U⁻¹ · scale · L⁻¹ · r."""

    _first: TriangularFactor
    _second: TriangularFactor

    def __init__(self, *, sweeps: int | None = None):
        self._sweeps = sweeps
        self._mid_scale = None  # optional (n,) tensor applied between solves

    def _place(self, first, second, dtype, mid_scale=None):
        self._first, self._second = first.astype(dtype), second.astype(dtype)
        if mid_scale is not None:
            self._mid_scale = torch.as_tensor(mid_scale, device=first.inv_diag.device).to(dtype)

    def __call__(self, r):
        if not profiling.recording():
            return self._apply(r)
        with profiling.annotate("precond.apply"):
            return self._apply(r)

    def _apply(self, r):
        y = tri_solve(self._first, r, sweeps=self._sweeps)
        if self._mid_scale is not None:
            y = self._mid_scale * y
        return tri_solve(self._second, y, sweeps=self._sweeps)

    def conj_apply(self, r):
        # SGS and IC are self-adjoint by construction; ILU's adjoint use is
        # out of scope, as in the JAX package.
        return self(r)


class SgsPreconditioner(_TwoSolvePreconditioner):
    """Symmetric Gauss–Seidel: M = (D+L) D⁻¹ (D+U), applied as
    M⁻¹r = (D+U)⁻¹ D (D+L)⁻¹ r.  The factors are the triangles of A itself.
    """

    def __init__(self, matrix, *, sweeps: int | None = None,
                 dtype: torch.dtype | None = None, device="cuda"):
        super().__init__(sweeps=sweeps)
        dev = resolve_device(device)
        row_ptr, cols, vals, n = _csr_host(matrix)
        lo, up, diag = _split_triangles(row_ptr, cols, vals, n)
        if np.any(diag == 0):
            raise ValueError("SGS needs a nonzero diagonal")
        self._place(build_triangular(*lo, n, lower=True, device=dev),
                    build_triangular(*up, n, lower=False, device=dev),
                    dtype or dtype_of(vals), mid_scale=diag)


def ilu0_factorize(row_ptr, cols, vals, n):
    """ILU(0): LU restricted to the sparsity pattern of A (IKJ form).

    Returns lu_vals aliasing the CSR pattern: strictly-lower entries hold
    L (unit diagonal implied), diagonal + upper hold U.  Dispatches to the
    native host runtime (``hostrt.cpp:stormx_ilu0``, bit-identical operation
    order) and falls back to the pure-Python reference implementation when
    the toolchain is missing.
    """
    from stormx_torch._native import native_ilu0

    lu = native_ilu0(row_ptr, cols, vals)
    if lu is not None:
        return lu
    return _ilu0_factorize_py(row_ptr, cols, vals, n)


def _ilu0_factorize_py(row_ptr, cols, vals, n):
    """Pure-Python ILU(0), the reference the native routine is tested
    against."""
    lu = np.array(vals, dtype=np.float64, copy=True)
    # Per-row column→slot lookup for O(1) pattern hits.
    slot = [
        {int(cols[k]): k for k in range(row_ptr[i], row_ptr[i + 1])}
        for i in range(n)
    ]
    diag_slot = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if i in slot[i]:
            diag_slot[i] = slot[i][i]
    if np.any(diag_slot < 0):
        raise ValueError("ILU(0) needs an explicitly stored diagonal")
    for i in range(n):
        row = sorted(slot[i].items())  # (j, slot) ascending
        for j, kij in row:
            if j >= i:
                break
            piv = lu[diag_slot[j]]
            if piv == 0:
                raise ZeroDivisionError(f"zero pivot at row {j} in ILU(0)")
            lik = lu[kij] / piv
            lu[kij] = lik
            # a[i, m] -= l[i,j] * u[j, m] for m > j in both patterns.
            for m, kjm in slot[j].items():
                if m <= j:
                    continue
                kim = slot[i].get(m)
                if kim is not None:
                    lu[kim] -= lik * lu[kjm]
    return lu


class IluPreconditioner(_TwoSolvePreconditioner):
    """ILU(0): host factorization in the pattern of A; apply = unit-lower
    solve, then upper solve."""

    def __init__(self, matrix, *, sweeps: int | None = None,
                 dtype: torch.dtype | None = None, device="cuda"):
        super().__init__(sweeps=sweeps)
        dev = resolve_device(device)
        row_ptr, cols, vals, n = _csr_host(matrix)
        lu = ilu0_factorize(row_ptr, cols, vals, n).astype(vals.dtype)
        lo, up, _ = _split_triangles(row_ptr, cols, lu, n)
        # The lower triple still carries diagonal slots (they belong to U);
        # ``unit_diagonal`` makes the builder skip j == i entries.
        self._place(build_triangular(*lo, n, lower=True, unit_diagonal=True, device=dev),
                    build_triangular(*up, n, lower=False, device=dev),
                    dtype or dtype_of(vals))


def _row_of(row_ptr, nnz):
    rows = np.zeros(nnz, dtype=np.int64)
    for i in range(len(row_ptr) - 1):
        rows[row_ptr[i] : row_ptr[i + 1]] = i
    return rows


def ic0_factorize_csr(row_ptr, cols, vals, n):
    """IC(0) factor L (A ≈ L·Lᵀ) as a CSR triple (lo_ptr, lo_cols, lo_vals)
    with ascending columns per row (diagonal last).

    Dispatches to the native host runtime (``hostrt.cpp:stormx_ic0``,
    bit-identical accumulation order) with a pure-Python fallback via
    :func:`ic0_factorize`.
    """
    from stormx_torch._native import native_ic0

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    cols = np.asarray(cols, dtype=np.int64)
    lm = cols <= rows
    lr, lc, lv = rows[lm], cols[lm], np.asarray(vals)[lm]
    order = np.lexsort((lc, lr))
    lr, lc, lv = lr[order], lc[order], lv[order]
    lo_ptr = np.zeros(n + 1, dtype=np.int64)
    lo_ptr[1:] = np.cumsum(np.bincount(lr, minlength=n))
    out = native_ic0(lo_ptr, lc, lv.astype(np.float64))
    if out is not None:
        return lo_ptr, lc.astype(np.int32), out
    l_cols, l_vals = ic0_factorize(row_ptr, cols, vals, n)
    # The Python builder appends ascending (diagonal last) already.
    flat_c = np.concatenate([np.asarray(c, dtype=np.int32) for c in l_cols])
    flat_v = np.concatenate([np.asarray(v, dtype=np.float64) for v in l_vals])
    return lo_ptr, flat_c, flat_v


def ic0_factorize(row_ptr, cols, vals, n):
    """IC(0): lower-triangular L with lower(A)'s pattern, A ≈ L·Lᵀ.

    Pure-Python reference implementation.  Returns per-row (cols, vals)
    lists of L including the diagonal.
    """
    l_cols = [[] for _ in range(n)]
    l_vals = [[] for _ in range(n)]
    l_slot = [dict() for _ in range(n)]  # col → index into l_vals[row]
    for i in range(n):
        aii = 0.0
        # Columns must be processed ascending; CSR rows need not be sorted.
        ks = sorted(range(row_ptr[i], row_ptr[i + 1]), key=lambda k: int(cols[k]))
        for k in ks:
            j = int(cols[k])
            if j > i:
                continue
            aij = float(vals[k])
            if j == i:
                aii = aij
                continue
            # l[i,j] = (a[i,j] - Σ_k l[i,k] l[j,k]) / l[j,j], k < j in both.
            s = aij
            for jj, v in zip(l_cols[i], l_vals[i]):
                kk = l_slot[j].get(jj)
                if kk is not None and jj < j:
                    s -= v * l_vals[j][kk]
            ljj = l_vals[j][l_slot[j][j]]
            lij = s / ljj
            l_slot[i][j] = len(l_cols[i])
            l_cols[i].append(j)
            l_vals[i].append(lij)
        # Sequential accumulation, NOT builtin sum(): CPython ≥ 3.12's sum()
        # is Neumaier-compensated and would differ from the native routine
        # by 1 ulp.
        sq = 0.0
        for v in l_vals[i]:
            sq += v * v
        s = aii - sq
        if s <= 0:
            raise ValueError(
                f"IC(0) breakdown at row {i}: non-positive pivot {s:g} "
                "(matrix not (nearly) SPD, or pattern too sparse)"
            )
        lii = float(np.sqrt(s))
        l_slot[i][i] = len(l_cols[i])
        l_cols[i].append(i)
        l_vals[i].append(lii)
    return l_cols, l_vals


class IcPreconditioner(_TwoSolvePreconditioner):
    """IC(0): M = L·Lᵀ for SPD A; apply = L-solve, then Lᵀ-solve.
    Self-adjoint, so CG-safe."""

    def __init__(self, matrix, *, sweeps: int | None = None,
                 dtype: torch.dtype | None = None, device="cuda"):
        super().__init__(sweeps=sweeps)
        dev = resolve_device(device)
        with profiling.annotate("precond.factor"):
            row_ptr, cols, vals, n = _csr_host(matrix)
            lo_ptr, lo_c, lo_v = ic0_factorize_csr(row_ptr, cols, vals, n)
            lo_v = lo_v.astype(vals.dtype)
            # Lᵀ in CSR = the upper triangle: transpose on the host.
            rows = _row_of(lo_ptr, len(lo_c))
            order = np.lexsort((rows, lo_c))  # sort by (col, row) → CSR of Lᵀ
            up_rows = lo_c[order].astype(np.int64)
            up_cols = rows[order].astype(np.int32)
            up_vals = lo_v[order]
            up_ptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(up_ptr, up_rows + 1, 1)
            up_ptr = np.cumsum(up_ptr)
        with profiling.annotate("precond.levels"):
            self._place(build_triangular(lo_ptr, lo_c, lo_v, n, lower=True, device=dev),
                        build_triangular(up_ptr, up_cols, up_vals, n, lower=False, device=dev),
                        dtype or dtype_of(vals))
