"""Aggregation AMG preconditioner (V-cycle) (counterpart of
``stormx/precond/multigrid.py``).

A plain (unsmoothed) aggregation AMG:

* **Set-up (host, NumPy, float64):** greedy root aggregation over the
  operator graph → piecewise-constant prolongation P; Galerkin coarse
  operator ``A_c = Pᵀ A P`` as a sparse triple product; recurse until the
  coarse problem is small, then factor it densely.  The same host code as
  the JAX package, so the hierarchy is bit for bit the same.
* **Apply (device):** V-cycle with weighted-Jacobi smoothing.  Per level:
  restrict = ``segment_sum`` by aggregate id (``index_add_``, atomics on the
  card), prolong = one gather, smooth = operator products + diagonal
  scaling.  ``fine_matvec`` routes the level-0 products through the
  caller's fast operator: on the card, ``auto_operator``'s SlicedELL, whose
  every product is kernel K1 (2·num_sweeps + 1 launches per V-cycle).

Usage: ``cg(op, b, x0, precond=AmgPreconditioner(csr))`` — it needs the
explicit CSR (matrix-free operators cannot be coarsened algebraically).
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.solvers.preconditioner import Preconditioner
from stormx_torch.sparse.formats import dtype_of, host, segment_sum

__all__ = ["AmgPreconditioner", "aggregate"]


def aggregate(row_ptr, cols, vals, n, theta: float = 0.25) -> np.ndarray:
    """Root-based aggregation over the strength graph — fully vectorized.

    Strength: |a_ij| ≥ θ·max_k |a_ik|.  Roots are a maximal independent set
    found in deterministic MIS rounds: each round, every free node whose
    hashed priority beats all free strong neighbours becomes a root and
    claims its free neighbours.  Leftovers join the highest-priority
    neighbouring aggregate; isolated nodes become singletons.  Deterministic
    (fixed priority permutation).  Returns aggregate ids (n,).

    ``theta``: strength threshold; the hierarchy loop passes a per-level
    decayed θ, since Galerkin coarse graphs densify.
    """
    row_ptr = np.asarray(row_ptr)
    cols = np.asarray(cols)
    av = np.abs(np.asarray(vals, dtype=np.float64))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    off = cols != rows
    rowmax = np.zeros(n)
    np.maximum.at(rowmax, rows[off], av[off])
    strong = off & (av >= theta * rowmax[rows])
    sr, sc = rows[strong], cols[strong]

    # Deterministic priority permutation (same for every call).
    pri = np.random.default_rng(0xA661).permutation(n).astype(np.int64)

    FREE, ROOT, COVERED = 0, 1, 2
    state = np.zeros(n, dtype=np.int8)
    root_of = np.full(n, -1, dtype=np.int64)
    for _ in range(64):
        free = state == FREE
        if not free.any():
            break
        e = free[sr] & free[sc]  # edges between free nodes
        nbr_max = np.full(n, -1, dtype=np.int64)
        np.maximum.at(nbr_max, sr[e], pri[sc[e]])
        new_roots = free & (pri > nbr_max)
        if not new_roots.any():
            break  # only isolated-in-free-graph nodes remain
        state[new_roots] = ROOT
        root_of[new_roots] = np.nonzero(new_roots)[0]
        # Free neighbours of new roots get claimed by the max-priority root.
        claim = new_roots[sr] & (state[sc] == FREE)
        if claim.any():
            best = np.full(n, -1, dtype=np.int64)
            np.maximum.at(best, sc[claim], pri[sr[claim]])
            inv_pri = np.empty(n, dtype=np.int64)
            inv_pri[pri] = np.arange(n)
            claimed = best >= 0
            state[claimed] = COVERED
            root_of[claimed] = inv_pri[best[claimed]]
    # Leftovers: attach to the max-priority aggregated strong neighbour.
    left = state == FREE
    if left.any():
        e = left[sr] & (state[sc] != FREE)
        best = np.full(n, -1, dtype=np.int64)
        np.maximum.at(best, sr[e], pri[sc[e]])
        inv_pri = np.empty(n, dtype=np.int64)
        inv_pri[pri] = np.arange(n)
        attach = left & (best >= 0)
        root_of[attach] = root_of[inv_pri[best[attach]]]
        # Truly isolated nodes become their own aggregates.
        solo = left & (best < 0)
        root_of[solo] = np.nonzero(solo)[0]
    # Relabel roots consecutively (stable in node order).
    _, agg = np.unique(root_of, return_inverse=True)
    return agg.astype(np.int64)


def _coarsen(row_ptr, cols, vals, n, agg, nc):
    """Galerkin triple product A_c = Pᵀ A P for piecewise-constant P."""
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    cr, cc = agg[rows], agg[cols]
    key = cr * nc + cc
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq))
    np.add.at(acc, inv, vals)
    ur, uc = uniq // nc, uniq % nc
    rp = np.zeros(nc + 1, dtype=np.int64)
    np.add.at(rp, ur + 1, 1)
    return np.cumsum(rp), uc.astype(np.int64), acc


class AmgPreconditioner(Preconditioner):
    """V-cycle aggregation AMG for SPD CSR operators.

    ``num_sweeps`` weighted-Jacobi (ω = 2/3) pre- and post-smoothing sweeps
    per level; coarse systems ≤ ``coarse_size`` are solved by a dense
    (pseudo-)inverse.  The set-up is float64 on the host.  Each level's
    arrays and the coarse inverse are then cast to ``dtype`` — the dtype of
    the vectors the preconditioner will be applied to, by default the
    CSR's — and placed on ``device`` (the card unless the caller asks for
    the CPU).  The JAX package keeps them in float64 and lets x64 promote a
    float32 residual; torch would raise on ``float64 @ float32`` and turn
    ``float32 * float64`` into float64, so the cast happens once here.
    """

    def __init__(self, csr, *, num_sweeps: int = 1, coarse_size: int = 64,
                 max_levels: int = 10, omega: float = 2.0 / 3.0, fine_matvec=None,
                 dtype: torch.dtype | None = None, device="cuda"):
        self.num_sweeps = num_sweeps
        self.omega = omega
        self._fine_matvec = fine_matvec
        dev = resolve_device(device)
        dtype = dtype or dtype_of(csr.data)

        def tensor(a):
            return torch.as_tensor(a, device=dev).to(dtype)

        def index(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        self._levels = []
        row_ptr = host(csr.row_ptr).astype(np.int64)
        cols = host(csr.indices).astype(np.int64)
        vals = host(csr.data).astype(np.float64)
        n = csr.shape[0]
        for level in range(max_levels):
            if n <= coarse_size:
                break
            # Decaying strength threshold (PyAMG-style): θ halves per level,
            # and a stagnating level retries once more at θ/4 before giving up.
            theta = max(0.25 * 0.5**level, 0.02)
            agg = aggregate(row_ptr, cols, vals, n, theta)
            nc = int(agg.max()) + 1
            if nc >= 0.75 * n:
                agg = aggregate(row_ptr, cols, vals, n, theta / 4.0)
                nc = int(agg.max()) + 1
            if nc >= 0.75 * n:
                break  # still stagnating: dense-solve here
            diag = np.zeros(n)
            rows = np.repeat(np.arange(n), np.diff(row_ptr))
            np.add.at(diag, rows[cols == rows], vals[cols == rows])
            # ELL layout for the level matvec: a (n, K) gather + row sum.
            counts = np.diff(row_ptr)
            K = max(int(counts.max()), 1)
            pos = np.arange(len(rows)) - row_ptr[rows]
            ell_cols = np.zeros((n, K), dtype=np.int64)
            ell_vals = np.zeros((n, K))
            ell_cols[rows, pos] = cols
            ell_vals[rows, pos] = vals
            self._levels.append({
                "ell_cols": index(ell_cols),
                "ell_vals": tensor(ell_vals),
                "inv_diag": tensor(
                    np.where(diag != 0.0, 1.0 / np.where(diag == 0, 1, diag), 0.0)),
                "agg": index(agg),
                "n": n,
                "nc": nc,
            })
            row_ptr, cols, vals = _coarsen(row_ptr, cols, vals, n, agg, nc)
            n = nc
        # Dense coarse factor (pseudo-inverse: pure-Neumann operators keep
        # their nullspace down the Galerkin hierarchy); eigh when symmetric.
        dense = np.zeros((n, n))
        rows = np.repeat(np.arange(n), np.diff(row_ptr))
        dense[rows, cols] = vals
        if n > 256 and np.array_equal(dense, dense.T):
            w, v = np.linalg.eigh(dense)
            tol = np.abs(w).max() * n * np.finfo(np.float64).eps
            inv_w = np.where(np.abs(w) > tol, 1.0 / np.where(w == 0.0, 1.0, w), 0.0)
            self._coarse_inv = tensor((v * inv_w) @ v.T)
        else:
            self._coarse_inv = tensor(np.linalg.pinv(dense))

    def build(self, x, b, op):
        return self

    # -- device-side V-cycle ------------------------------------------------
    def _matvec(self, lvl, x, k):
        if k == 0 and self._fine_matvec is not None:
            return self._fine_matvec(x)
        return (lvl["ell_vals"] * x[lvl["ell_cols"]]).sum(dim=1)

    def _smooth(self, lvl, x, b, k):
        for _ in range(self.num_sweeps):
            r = b - self._matvec(lvl, x, k)
            x = x + self.omega * lvl["inv_diag"] * r
        return x

    def _vcycle(self, k, b):
        if k == len(self._levels):
            return self._coarse_inv @ b
        lvl = self._levels[k]
        x = self._smooth(lvl, torch.zeros_like(b), b, k)
        r = b - self._matvec(lvl, x, k)
        r_c = segment_sum(r, lvl["agg"], lvl["nc"])
        e_c = self._vcycle(k + 1, r_c)
        x = x + e_c[lvl["agg"]]
        return self._smooth(lvl, x, b, k)

    def __call__(self, r):
        return self._vcycle(0, r)

    def conj_apply(self, r):
        return self(r)
