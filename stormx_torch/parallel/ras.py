"""Restricted additive Schwarz (zero overlap) with ILU(0) or SGS blocks for
distributed solves (counterpart of ``stormx/parallel/ras.py``).

Each partition factorizes its OWNED diagonal block A_pp on the host (ILU(0)
or the SGS splitting) and applies it locally — no communication in the
apply.  This is block-Jacobi with incomplete inner factorizations: the
preconditioned operator (and so the history) DEPENDS on the partition
count, unlike every other preconditioner of the package; more partitions
drop more coupling and take more iterations.

SGS blocks of an SPD operator are SPD, so CG stays safe; ILU(0) blocks are
nonsymmetric in general — use BiCGStab/GMRES.  The apply is two exact
level-scheduled triangular solves (``tri_solve``), a launch per level each.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.sparse.formats import host

__all__ = ["build_ras_factors", "RAS_KEYS"]

# Key order of the stacked factors (the JAX package's operand order).
RAS_KEYS = (
    "ras_lr1", "ras_ec1", "ras_ev1", "ras_id1",
    "ras_lr2", "ras_ec2", "ras_ev2", "ras_id2",
    "ras_mid",
)


def _local_block_csr(data_p, cols_p, n_pad):
    """Owned-block CSR of one partition (foreign columns dropped), with an
    identity diagonal injected for empty padding rows."""
    K = data_p.shape[1]
    rows = np.repeat(np.arange(n_pad), K)
    cc = cols_p.reshape(-1)
    dd = data_p.reshape(-1)
    keep = (dd != 0) & (cc < n_pad)
    rows, cc, dd = rows[keep], cc[keep], dd[keep]
    has_diag = np.zeros(n_pad, dtype=bool)
    has_diag[rows[cc == rows]] = True
    add = np.nonzero(~has_diag)[0]
    rows = np.concatenate([rows, add])
    cc = np.concatenate([cc, add])
    dd = np.concatenate([dd, np.ones(len(add), dd.dtype)])
    order = np.lexsort((cc, rows))
    rows, cc, dd = rows[order], cc[order], dd[order]
    rp = np.zeros(n_pad + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return np.cumsum(rp), cc.astype(np.int32), dd


def _part_factors(data_p, cols_p, n_pad, kind):
    """(first factor, second factor, middle scale) of one partition's block,
    on the host."""
    from stormx_torch.precond.factorized import _split_triangles, ilu0_factorize
    from stormx_torch.precond.triangular import build_triangular

    rp, cc, dd = _local_block_csr(data_p, cols_p, n_pad)
    if kind == "ilu0":
        lu = ilu0_factorize(rp, cc, dd, n_pad).astype(dd.dtype)
        lo, up, _ = _split_triangles(rp, cc, lu, n_pad)
        return (build_triangular(*lo, n_pad, lower=True, unit_diagonal=True, device="cpu"),
                build_triangular(*up, n_pad, lower=False, device="cpu"),
                np.ones(n_pad, dtype=dd.dtype))
    if kind == "sgs":
        lo, up, diag = _split_triangles(rp, cc, dd, n_pad)
        if np.any(diag == 0):
            raise ValueError("RAS-SGS needs nonzero block diagonals")
        return (build_triangular(*lo, n_pad, lower=True, device="cpu"),
                build_triangular(*up, n_pad, lower=False, device="cpu"),
                diag)
    raise ValueError(f"unknown RAS kind {kind!r}")


def _pad_stack(factors, n_pad):
    """Stack per-part TriangularFactors into (P, ...) arrays (level counts
    and widths padded with the dump row n_pad → processed as no-ops)."""
    L = max(int(f.level_rows.shape[0]) for f in factors)
    W = max(int(f.level_rows.shape[1]) for f in factors)
    K = max(int(f.ell_cols.shape[1]) for f in factors)
    lr = np.full((len(factors), L, W), n_pad, dtype=np.int64)
    ec = np.zeros((len(factors), n_pad + 1, K), dtype=np.int64)
    ev = np.zeros((len(factors), n_pad + 1, K), dtype=host(factors[0].ell_vals).dtype)
    idg = np.zeros((len(factors), n_pad + 1), dtype=host(factors[0].inv_diag).dtype)
    for p, f in enumerate(factors):
        l, w = f.level_rows.shape
        lr[p, :l, :w] = host(f.level_rows)
        k = f.ell_cols.shape[1]
        ec[p, :, :k] = host(f.ell_cols)
        ev[p, :, :k] = host(f.ell_vals)
        idg[p] = host(f.inv_diag)
    return lr, ec, ev, idg


def build_ras_factors(pop, kind: str = "ilu0") -> dict:
    """Host-factorize every partition's owned block; returns the stacked
    factors by :data:`RAS_KEYS`, on the operator's device.

    ``kind``: ``"ilu0"`` (nonsymmetric apply → BiCGStab/GMRES) or ``"sgs"``
    (SPD-preserving → CG-safe on SPD operators).
    """
    P, n_pad, _ = pop.data.shape
    data, cols = host(pop.data), host(pop.cols)
    parts = [_part_factors(data[p], cols[p], n_pad, kind) for p in range(P)]
    stacked = (_pad_stack([f[0] for f in parts], n_pad)
               + _pad_stack([f[1] for f in parts], n_pad)
               + (np.stack([f[2] for f in parts]),))
    dev = pop.data.device
    return {k: torch.as_tensor(a, device=dev) for k, a in zip(RAS_KEYS, stacked)}


def _rank_preconditioner(pop, kind: str, rank: int, *, dtype, device):
    """The RAS apply of one rank, ``r ↦ U⁻¹·mid·L⁻¹·r`` on its owned block:
    only this rank's block is factorized."""
    from stormx_torch.precond.triangular import tri_solve
    from stormx_torch.solvers.preconditioner import FunctionPreconditioner

    first, second, mid = _part_factors(host(pop.data[rank]), host(pop.cols[rank]),
                                       pop.n_pad, kind)

    def place(f):
        return type(f)(*(t.to(device) for t in f)).astype(dtype)

    f1, f2 = place(first), place(second)
    mid = torch.as_tensor(mid, device=device).to(dtype)
    return FunctionPreconditioner(lambda r: tri_solve(f2, mid * tri_solve(f1, r)))
