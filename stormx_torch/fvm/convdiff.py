"""Scalar upwind convection–diffusion operator, BASELINE config #2's
nonsymmetric convection-diffusion operator, assembled from the mesh
(counterpart of ``stormx/fvm/convdiff.py``).

    A·u = div(v·u) − ε·∇²u        (volume-weighted rows)

* convection: 1st-order upwind flux per face, ``flux_f = (v·n)⁺·u_inner +
  (v·n)⁻·u_outer``, zero-value inflow / free outflow at the boundary (a
  scalar far-field with value 0, ``Feathers/SkunkFvBC.hpp:71-90``);
* diffusion: the two-point flux of :func:`~stormx_torch.fvm.divgrad.div_grad`
  on interior faces (no-flux boundary).

:func:`convection_diffusion_operator` composes it matrix-free from the FVM
operators (K3 when the mesh carries plans); :func:`assemble_convection_diffusion`
assembles the same operator on the host as an ``ELL`` (CPU tensors; put it on
the card with ``auto_operator``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "face_normal_velocity",
    "scalar_upwind_flux",
    "zero_farfield_bc",
    "convection_diffusion_operator",
    "assemble_convection_diffusion",
]


def face_normal_velocity(mesh, velocity) -> np.ndarray:
    """Per-face normal velocity v(face_center)·n (host NumPy).

    ``velocity``: callable ``r -> (m, dim)`` or a constant ``(dim,)`` array.
    """
    centers = np.asarray(mesh.face_centers)
    normals = np.asarray(mesh.face_normals)
    if callable(velocity):
        vel = np.asarray(velocity(centers))
    else:
        vel = np.broadcast_to(np.asarray(velocity), centers.shape)
    return np.einsum("fd,fd->f", vel, normals)


def scalar_upwind_flux(vn):
    """Flux-scheme closure for :func:`~stormx_torch.fvm.convection.upwind_convection`
    advecting a scalar with per-face normal velocity ``vn`` (a tensor on the
    states' device): flux = (v·n)⁺·u_in + (v·n)⁻·u_out."""
    vn = torch.as_tensor(vn)

    def flux(n, u_out, u_in):
        v = vn[:, None]
        return torch.where(v > 0, v * u_in, v * u_out)

    return flux


def zero_farfield_bc(n, r, u_inner):
    """Scalar far-field with value 0: inflow faces advect 0 in; outflow
    faces never read the ghost (upwind selects the inner state)."""
    return torch.zeros_like(u_inner)


def convection_diffusion_operator(dmesh, vn, eps, bcs=None):
    """Matrix-free A·u = div(v·u) − ε·∇²u from the FVM operators.

    ``vn``: per-face normal velocity (see :func:`face_normal_velocity`),
    moved once to the mesh's device and dtype.  Returns a callable on
    (num_cells,) cell fields.
    """
    from stormx_torch.fvm.convection import upwind_convection
    from stormx_torch.fvm.divgrad import div_grad

    if bcs is None:
        bcs = {label: zero_farfield_bc for label in range(1, len(dmesh.face_label_ranges) - 1)}
    flux = scalar_upwind_flux(torch.as_tensor(vn, dtype=dmesh.cell_volumes.dtype,
                                              device=dmesh.device))

    def apply(u):
        conv = upwind_convection(dmesh, u[:, None], bcs, flux_scheme=flux)[:, 0]
        return div_grad(dmesh, conv, -eps, u)

    return apply


def assemble_convection_diffusion(mesh, velocity, eps):
    """Host assembly of the upwind convection–diffusion operator.

    Row stencil (volume-weighted, matching the matrix-free form):

    interior face f = (i → o), a = area_f, w = ε·a/dist_f, c = a·(v·n)_f:
        row i:  u_i · (c⁺ + w)/vol_i  +  u_o · (c⁻ − w)/vol_i
        row o:  u_o · (−c⁻ + w)/vol_o +  u_i · (−c⁺ − w)/vol_o
    boundary face of cell i (zero-value inflow / free outflow; diffusion is
    no-flux as in ``div_grad``):
        row i:  u_i · c⁺/vol_i

    Returns a float64 :class:`~stormx_torch.sparse.formats.ELL` of CPU
    tensors (``.to_csr()`` converts it).
    """
    from stormx_torch.sparse.formats import COO, ell_from_csr

    vn = face_normal_velocity(mesh, velocity)
    vol = np.asarray(mesh.cell_volumes)
    area = np.asarray(mesh.face_areas)

    interior = mesh.interior_faces()
    inner = mesh.face_cells[interior, 0]
    outer = mesh.face_cells[interior, 1]
    dist = np.linalg.norm(mesh.cell_centers[outer] - mesh.cell_centers[inner], axis=1)
    w = eps * area[interior] / dist
    c = area[interior] * vn[interior]
    c_pos = np.maximum(c, 0.0)
    c_neg = np.minimum(c, 0.0)

    boundary = mesh.boundary_faces()
    b_inner = mesh.face_cells[boundary, 0]
    cb_pos = np.maximum(area[boundary] * vn[boundary], 0.0)

    rows = np.concatenate([inner, inner, outer, outer, b_inner])
    cols = np.concatenate([inner, outer, outer, inner, b_inner])
    data = np.concatenate(
        [
            (c_pos + w) / vol[inner],
            (c_neg - w) / vol[inner],
            (-c_neg + w) / vol[outer],
            (-c_pos - w) / vol[outer],
            cb_pos / vol[b_inner],
        ]
    )
    coo = COO(
        data=torch.as_tensor(data),
        rows=torch.as_tensor(rows.astype(np.int32)),
        cols=torch.as_tensor(cols.astype(np.int32)),
        shape=(mesh.num_cells, mesh.num_cells),
    )
    return ell_from_csr(coo.to_csr())
