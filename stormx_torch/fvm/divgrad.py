"""Two-point flux div-grad operator (counterpart of ``stormx/fvm/divgrad.py``;
reference ``stormDivGrad``, ``Playground.cpp:116-131``).

The per-face flux is one gather pass, and the per-cell accumulation uses the
cell←face ELL incidence table — a second gather — so no scatter appears.
When the :class:`DeviceMesh` carries banded-gather plans the three gathers
go through kernel K3 (bit-exact).  ``assemble_*`` build the explicit
operators on the host; ``assemble_divgrad_dia`` gives the banded ``DIA``
form, whose matvec is kernel K2a on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import resolve_device
from stormx_torch.ops import safe_divide
from stormx_torch.sparse.formats import COO, CSR, DIA, ELL, dia_from_csr, ell_from_csr

__all__ = [
    "div_grad",
    "face_flux_coefficients",
    "assemble_divgrad",
    "assemble_laplacian",
    "assemble_divgrad_dia",
]


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


def assemble_divgrad_dia(mesh, scale=1.0, *, reorder=False, max_diags=64,
                         device="cuda") -> tuple[DIA, np.ndarray]:
    """Assemble div-grad as a banded :class:`DIA` operator on ``device``.

    On (quasi-)structured meshes the cell adjacency has a handful of
    distinct index offsets.  ``reorder=True`` applies RCM first; on fully
    unstructured meshes the number of offsets stays O(bandwidth), and more
    than ``max_diags`` raises (use :func:`assemble_divgrad` there).

    Returns ``(dia, perm)`` with ``perm[new] = old`` cell order (identity
    when ``reorder=False``): solve for ``x_new`` with ``b_new = b[perm]``,
    then ``x[perm] = x_new``.  The data is float64, like the ELL form.
    """
    dev = resolve_device(device)
    ell = assemble_divgrad(mesh, scale)
    n = mesh.num_cells
    cols = ell.cols.numpy()
    data = ell.data.numpy()
    rows = np.repeat(np.arange(n), cols.shape[1])
    flat_cols = cols.reshape(-1)
    flat_data = data.reshape(-1)
    keep = flat_data != 0.0
    rows, flat_cols, flat_data = rows[keep], flat_cols[keep], flat_data[keep]

    if reorder:
        from stormx_torch.parallel.partition import rcm_order

        perm = rcm_order(n, rows, flat_cols.astype(np.int64))
    else:
        perm = np.arange(n, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows = inv[rows]
    flat_cols = inv[flat_cols]

    order = np.lexsort((flat_cols, rows))
    rows, flat_cols, flat_data = rows[order], flat_cols[order], flat_data[order]
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(row_ptr, rows.astype(np.int64) + 1, 1)
    csr = CSR(data=flat_data, indices=flat_cols.astype(np.int32),
              row_ptr=np.cumsum(row_ptr).astype(np.int32), shape=(n, n))
    dia = dia_from_csr(csr, max_diags=max_diags)
    return DIA(data=dia.data.to(dev), offsets=dia.offsets, shape=dia.shape), perm
