"""Two-point flux div-grad operator (counterpart of ``stormx/fvm/divgrad.py``;
reference ``stormDivGrad``, ``Playground.cpp:116-131``).

The per-face flux is one gather pass, and the per-cell accumulation uses the
cell←face ELL incidence table — a second gather — so no scatter appears.
When the :class:`DeviceMesh` carries banded-gather plans the three gathers
go through kernel K3 (bit-exact).  ``assemble_*`` build the explicit
operators on the host; ``assemble_divgrad_dia`` waits for the DIA slice.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.ops import safe_divide
from stormx_torch.sparse.formats import COO, ELL, ell_from_csr

__all__ = ["div_grad", "face_flux_coefficients", "assemble_divgrad", "assemble_laplacian"]


def face_flux_coefficients(dmesh) -> torch.Tensor:
    """Per-face coefficient area/dist for interior faces, 0 on boundary."""
    return safe_divide(dmesh.face_areas, dmesh.face_dist)


def div_grad(dmesh, u: torch.Tensor, dt, c: torch.Tensor) -> torch.Tensor:
    """u + dt·∇·(∇c) in the reference's discrete form (no-flux boundary).

    ``u``/``c`` are cell fields ``(num_cells,)`` or ``(num_cells, nv)``.
    """
    coef = face_flux_coefficients(dmesh)
    if dmesh.bg_face_inner is not None:
        # Banded gathers; the boundary outer→inner clamp matches the 0-clamp
        # since coef = 0 there.
        c_inner = dmesh.bg_face_inner(c)
        c_outer = dmesh.bg_face_outer(c)
    else:
        c_inner = c[dmesh.face_inner]
        c_outer = c[torch.clamp(dmesh.face_outer, min=0)]
    diff = c_outer - c_inner
    flux = dt * coef[..., None] * diff if c.dim() == 2 else dt * coef * diff

    if dmesh.bg_cell_face is not None:
        K = dmesh.cell_face_ell.shape[1]
        g = dmesh.bg_cell_face(flux).reshape((dmesh.num_cells, K) + tuple(flux.shape[1:]))
    else:
        g = flux[dmesh.cell_face_ell]
    sgn = dmesh.cell_face_sign
    vol = dmesh.cell_volumes
    if c.dim() == 2:
        acc = torch.sum(sgn[..., None] * g, dim=1) / vol[:, None]
    else:
        acc = torch.sum(sgn * g, dim=1) / vol
    return u + acc


def _two_point_coo(mesh, data_fn, scale) -> COO:
    interior = mesh.interior_faces()
    inner = mesh.face_cells[interior, 0]
    outer = mesh.face_cells[interior, 1]
    dist = np.linalg.norm(mesh.cell_centers[outer] - mesh.cell_centers[inner], axis=1)
    w = scale * mesh.face_areas[interior] / dist
    rows = np.concatenate([inner, outer, inner, outer])
    cols = np.concatenate([outer, inner, inner, outer])
    return COO(
        data=torch.as_tensor(data_fn(w, inner, outer)),
        rows=torch.as_tensor(rows.astype(np.int32)),
        cols=torch.as_tensor(cols.astype(np.int32)),
        shape=(mesh.num_cells, mesh.num_cells),
    )


def assemble_divgrad(mesh, scale=1.0) -> ELL:
    """Explicit div-grad operator as a host ELL matrix (CPU tensors).

    Row i: Σ_f (area_f/dist_f)·(c_adj − c_i)·scale / vol_i.
    """
    vol = mesh.cell_volumes

    def data(w, inner, outer):
        return np.concatenate(
            [w / vol[inner], w / vol[outer], -w / vol[inner], -w / vol[outer]]
        )

    return ell_from_csr(_two_point_coo(mesh, data, scale).to_csr())


def assemble_laplacian(mesh, scale=1.0) -> ELL:
    """The SYMMETRIC two-point-flux Laplacian L (no 1/volume weighting):
    diag Σ_f w_f, off-diag −w_f with w_f = area_f/dist_f.  SPD up to the
    constant nullspace, so CG is safe on any mesh.  Host ELL (CPU tensors).
    """

    def data(w, inner, outer):
        return np.concatenate([-w, -w, w, w])

    return ell_from_csr(_two_point_coo(mesh, data, scale).to_csr())
