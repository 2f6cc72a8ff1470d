"""Sparse approximate-inverse preconditioners: SPAI(0) and factored AINV
(counterpart of ``stormx/precond/approx_inverse.py``).

The apply is plain SpMV (no triangular solves, no recurrences); all the
factorization work happens once on the host, in the JAX package's own
per-row Python, so the factors are bit for bit the JAX package's.

* **SPAI(0)** — static-pattern Frobenius-norm minimization: column m_j of M
  minimizes ‖A m_j − e_j‖₂ over the sparsity pattern of A's column a_j
  (Grote & Huckle, SISC 18(3), 1997, pattern level 0).
* **AINV** — factored sparse approximate inverse for SPD A:
  A⁻¹ ≈ Z D⁻¹ Zᵀ with Z unit upper triangular, built by incomplete
  biconjugation with a drop tolerance (Benzi–Meyer–Tůma, SISC 17(5), 1996).
  Apply = two SpMVs + a diagonal scale; self-adjoint, hence CG-safe.

Both constructors take ``dtype`` (a torch dtype, by default the matrix's)
and ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.solvers.preconditioner import Preconditioner
from stormx_torch.sparse.formats import CSR, dtype_of, host

__all__ = ["SpaiPreconditioner", "AinvPreconditioner", "spai0_build", "ainv_build"]


def _csr_host(csr):
    return host(csr.row_ptr), host(csr.indices), host(csr.data), csr.shape[0], csr.shape[1]


def _to_device_csr(row_ptr, cols, vals, shape, dtype, device) -> CSR:
    return CSR(
        data=torch.as_tensor(vals, device=device).to(dtype),
        indices=torch.as_tensor(np.asarray(cols, dtype=np.int32), device=device),
        row_ptr=torch.as_tensor(np.asarray(row_ptr, dtype=np.int32), device=device),
        shape=shape,
    )


def _transpose_host(row_ptr, cols, vals, n_rows, n_cols):
    """CSR triples of the transpose (rows ascending within each row)."""
    rows_of = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    order = np.lexsort((rows_of, cols))
    t_ptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.add.at(t_ptr, cols.astype(np.int64) + 1, 1)
    return np.cumsum(t_ptr), rows_of[order].astype(np.int32), vals[order]


def spai0_build(row_ptr, cols, vals, n):
    """SPAI with M's pattern = A's pattern.  Returns CSR triples of M.

    Column j: J = pattern(a_j) (rows of A's column j); I = rows where
    A[:, J] has entries.  Solve the |I|×|J| least-squares
    min ‖A[I,J] m − e_j[I]‖ and scatter m into column j of M.
    """
    # Column access: build CSC index of A.
    rows_of = np.repeat(np.arange(n), np.diff(row_ptr))
    order = np.lexsort((rows_of, cols))
    csc_rows = rows_of[order]
    csc_vals = vals[order]
    csc_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(csc_ptr, cols.astype(np.int64) + 1, 1)
    csc_ptr = np.cumsum(csc_ptr)

    m_cols_per_row: list[list[int]] = [[] for _ in range(n)]
    m_vals_per_row: list[list[float]] = [[] for _ in range(n)]
    for j in range(n):
        J = csc_rows[csc_ptr[j] : csc_ptr[j + 1]]
        if len(J) == 0:
            continue
        # I = union of patterns of columns in J (rows of A[:, J]).
        I = np.unique(np.concatenate([csc_rows[csc_ptr[k] : csc_ptr[k + 1]] for k in J]))
        i_pos = {int(r): p for p, r in enumerate(I)}
        a_sub = np.zeros((len(I), len(J)), dtype=np.float64)
        for c, k in enumerate(J):
            for p in range(csc_ptr[k], csc_ptr[k + 1]):
                a_sub[i_pos[int(csc_rows[p])], c] = csc_vals[p]
        e = np.zeros(len(I), dtype=np.float64)
        e[i_pos[j]] = 1.0
        m, *_ = np.linalg.lstsq(a_sub, e, rcond=None)
        for c, k in enumerate(J):
            m_cols_per_row[int(k)].append(j)
            m_vals_per_row[int(k)].append(float(m[c]))

    out_ptr = np.zeros(n + 1, dtype=np.int64)
    out_c, out_v = [], []
    for i in range(n):
        order = np.argsort(m_cols_per_row[i])
        out_c.extend(np.asarray(m_cols_per_row[i], dtype=np.int64)[order])
        out_v.extend(np.asarray(m_vals_per_row[i])[order])
        out_ptr[i + 1] = len(out_c)
    return (
        out_ptr,
        np.asarray(out_c, dtype=np.int32),
        np.asarray(out_v, dtype=vals.dtype),
    )


class SpaiPreconditioner(Preconditioner):
    """SPAI(0) — M ≈ A⁻¹ minimizing ‖AM − I‖_F over A's pattern.
    Apply = M·r (one SpMV); ``conj_apply`` = Mᵀ·r through a transposed CSR
    built on the host at its first call and kept."""

    def __init__(self, matrix, *, dtype: torch.dtype | None = None, device="cuda"):
        dev = resolve_device(device)
        row_ptr, cols, vals, nr, nc = _csr_host(matrix)
        if nr != nc:
            raise ValueError("SPAI(0) needs a square matrix")
        m_ptr, m_cols, m_vals = spai0_build(row_ptr, cols, vals, nr)
        self._m = _to_device_csr(m_ptr, m_cols, m_vals, (nr, nc), dtype or dtype_of(vals), dev)
        self._mt = None

    def __call__(self, r):
        return self._m.matvec(r)

    def conj_apply(self, r):
        if self._mt is None:
            m = self._m
            t = _transpose_host(host(m.row_ptr), host(m.indices), host(m.data), *m.shape)
            self._mt = _to_device_csr(*t, m.shape[::-1], m.data.dtype, m.data.device)
        return self._mt.matvec(r)


def ainv_build(row_ptr, cols, vals, n, drop_tol=0.1):
    """Factored AINV for SPD A: returns (Z rows as CSR triples, inv_d).

    Right-looking outer-product biconjugation: start Z = I; at step i,
    d_i = aᵢᵀ z_i, then for j > i with p_j = aᵢᵀ z_j ≠ 0:
    z_j ← z_j − (p_j/d_i) z_i, dropping entries below ``drop_tol`` relative
    to the column norm.  Z is unit upper triangular (z_j holds rows ≤ j).
    """
    # Columns of Z as dicts row→val; z_j starts as e_j.
    z = [{j: 1.0} for j in range(n)]
    inv_d = np.zeros(n, dtype=np.float64)
    a_rows = [
        (cols[row_ptr[i] : row_ptr[i + 1]], vals[row_ptr[i] : row_ptr[i + 1]])
        for i in range(n)
    ]
    # For each row r, the columns j that currently hold a nonzero z_j[r].
    holders: list[set] = [set() for _ in range(n)]
    for j in range(n):
        holders[j].add(j)

    def a_dot_z(i, zj):
        c, v = a_rows[i]
        return sum(float(v[k]) * zj.get(int(c[k]), 0.0) for k in range(len(c)))

    for i in range(n):
        d = a_dot_z(i, z[i])
        if d <= 0:
            raise ValueError(f"AINV breakdown at column {i}: pivot {d:g} ≤ 0")
        inv_d[i] = 1.0 / d
        c, _ = a_rows[i]
        touched = set()
        for k in range(len(c)):
            touched |= holders[int(c[k])]
        for j in sorted(touched):
            if j <= i:
                continue
            p = a_dot_z(i, z[j])
            if p == 0.0:
                continue
            alpha = p * inv_d[i]
            zj = z[j]
            for r, v in z[i].items():
                zj[r] = zj.get(r, 0.0) - alpha * v
            # Drop small entries (keep the unit diagonal).
            norm = max(abs(v) for v in zj.values())
            for r in [r for r, v in zj.items() if r != j and abs(v) < drop_tol * norm]:
                del zj[r]
                holders[r].discard(j)
            for r in zj:
                holders[r].add(j)

    # Freeze Z to CSR (rows of Z: entry Z[r, j] = z[j][r]).
    z_ptr = np.zeros(n + 1, dtype=np.int64)
    rows_acc: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for j in range(n):
        for r, v in z[j].items():
            rows_acc[r].append((j, v))
    z_c, z_v = [], []
    for r in range(n):
        for j, v in sorted(rows_acc[r]):
            z_c.append(j)
            z_v.append(v)
        z_ptr[r + 1] = len(z_c)
    return (z_ptr, np.asarray(z_c, dtype=np.int32), np.asarray(z_v)), inv_d


class AinvPreconditioner(Preconditioner):
    """Factored AINV: M⁻¹ = Z D⁻¹ Zᵀ ≈ A⁻¹ for SPD A.
    Apply = SpMVᵀ → scale → SpMV."""

    def __init__(self, matrix, *, drop_tol: float = 0.1, dtype: torch.dtype | None = None,
                 device="cuda"):
        dev = resolve_device(device)
        row_ptr, cols, vals, nr, nc = _csr_host(matrix)
        if nr != nc:
            raise ValueError("AINV needs a square SPD matrix")
        (z_ptr, z_c, z_v), inv_d = ainv_build(
            row_ptr, cols, np.asarray(vals, dtype=np.float64), nr, drop_tol
        )
        host_dtype = vals.dtype
        dtype = dtype or dtype_of(vals)
        self._z = _to_device_csr(z_ptr, z_c, z_v.astype(host_dtype), (nr, nc), dtype, dev)
        t_ptr, t_c, t_v = _transpose_host(z_ptr, z_c, z_v, nr, nc)
        self._zt = _to_device_csr(t_ptr, t_c, t_v.astype(host_dtype), (nc, nr), dtype, dev)
        self._inv_d = torch.as_tensor(inv_d.astype(host_dtype), device=dev).to(dtype)

    def __call__(self, r):
        return self._z.matvec(self._inv_d * self._zt.matvec(r))

    def conj_apply(self, r):
        return self(r)  # symmetric by construction
