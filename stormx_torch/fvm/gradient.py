"""Least-squares cell-centered gradients (counterpart of
``stormx/fvm/gradient.py``; reference ``Feathers/GradientScheme.hpp:37-85``).

Per cell the inverse LSQ matrix G = (εI + Σ_adj dr⊗dr)⁻¹ is computed once;
then ∇u = G·Σ_adj (u_adj − u)·dr.  The adjacency loop is the
``cell_adj_ell`` gather (padding = self, so dr = 0 adds nothing), through
kernel K3's ``bg_cell_adj`` plan when the mesh carries plans.  The
contractions over the K neighbours and the dim × dim matrices are
broadcast products summed over one axis: ``torch.einsum`` sends them to
batched matrix products of 2×2 or 3×3 blocks, which the card runs far below
its memory rate.
"""

from __future__ import annotations

import torch

__all__ = ["lsq_gradient_matrices", "gather_adjacent", "lsq_gradients"]

_EPS = 1e-14  # GradientScheme.hpp:58


def lsq_gradient_matrices(dmesh) -> torch.Tensor:
    """(num_cells, dim, dim) inverse LSQ matrices (GradientScheme.hpp:50-62).

    The regularization is the reference's absolute 1e-14 plus 100·ε of the
    dtype times the trace: corner cells with fewer than ``dim`` independent
    neighbors make Σ dr⊗dr singular, and in float32 an absolute 1e-14
    underflows against O(h²) entries, so the inverse would carry Inf.  Set-up
    work, once per mesh.
    """
    centers = dmesh.cell_centers  # (n, dim)
    adj = dmesh.cell_adj_ell  # (n, K)
    dr = centers[adj] - centers[:, None, :]  # (n, K, dim)
    outer = torch.einsum("nki,nkj->nij", dr, dr)
    dim = centers.shape[1]
    tr = torch.diagonal(outer, dim1=-2, dim2=-1).sum(-1)
    eps = _EPS + 100.0 * torch.finfo(centers.dtype).eps * tr
    eye = torch.eye(dim, dtype=centers.dtype, device=centers.device)
    return torch.linalg.inv(outer + eps[:, None, None] * eye)


def gather_adjacent(dmesh, v: torch.Tensor) -> torch.Tensor:
    """v[cell_adj_ell], (n, K[, c]), through K3 when the mesh carries plans
    (bit-exact); v is (n,) or (n, c)."""
    adj = dmesh.cell_adj_ell
    if dmesh.bg_cell_adj is not None:
        return dmesh.bg_cell_adj(v).reshape((dmesh.num_cells, adj.shape[1]) + tuple(v.shape[1:]))
    return v[adj]


def lsq_gradients(dmesh, u: torch.Tensor, g_mats=None) -> torch.Tensor:
    """∇u per cell: (num_cells, dim) or (num_cells, nv, dim)
    (GradientScheme.hpp:64-84)."""
    if g_mats is None:
        g_mats = lsq_gradient_matrices(dmesh)
    centers = dmesh.cell_centers
    dr = gather_adjacent(dmesh, centers) - centers[:, None, :]  # (n, K, dim)
    du = gather_adjacent(dmesh, u) - u[:, None]  # (n, K) or (n, K, nv)
    if u.dim() == 2:
        rhs = (du[..., None] * dr[:, :, None, :]).sum(1)  # (n, nv, dim)
        return (g_mats[:, None, :, :] * rhs[:, :, None, :]).sum(-1)
    rhs = (du[..., None] * dr).sum(1)  # (n, dim)
    return (g_mats * rhs[:, None, :]).sum(-1)
