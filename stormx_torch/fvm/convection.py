"""Upwind convection schemes: 1st-order and limited 2nd-order (linear)
(counterpart of ``stormx/fvm/convection.py``; reference
``Feathers/ConvectionScheme.hpp:57-198``).

The reference's two serial face loops (interior flux scatter, per-label
boundary loop) become one vectorized flux over all faces (interior states
and per-label ghost states, each label a contiguous slice of the
label-sorted faces) and one gather-accumulate over the signed cell←face ELL
table.  Every gather goes through kernel K3 when the mesh carries its plans
(bit-exact): a 2nd-order step launches it eleven times, a 1st-order step
three times.
"""

from __future__ import annotations

import torch

from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.flux import lax_friedrichs_flux
from stormx_torch.fvm.gradient import lsq_gradient_matrices, lsq_gradients
from stormx_torch.fvm.limiter import compute_limiters, cubic_limiter, cubic_second_limiter

__all__ = ["upwind_convection", "linear_upwind_convection"]


def _accumulate(dmesh, face_flux):
    """div_f[c] = Σ_f sign·(area_f/vol_c)·flux_f via the gather table."""
    af = face_flux * dmesh.face_areas[:, None]  # (num_faces, nv)
    if dmesh.bg_cell_face is not None:
        K = dmesh.cell_face_ell.shape[1]
        g = dmesh.bg_cell_face(af).reshape(dmesh.num_cells, K, af.shape[1])
    else:
        g = af[dmesh.cell_face_ell]  # (n, K, nv)
    acc = torch.sum(dmesh.cell_face_sign[..., None] * g, dim=1)
    return acc / dmesh.cell_volumes[:, None]


def _face_states(dmesh, u):
    """(u[face_inner], u[face_outer clamped to the inner cell]), through K3
    when the mesh carries plans.  Both are new tensors."""
    if dmesh.bg_face_inner is not None:
        return dmesh.bg_face_inner(u), dmesh.bg_face_outer(u)
    return u[dmesh.face_inner], u[torch.clamp(dmesh.face_outer, min=0)]


def _set_boundary_ghosts(dmesh, u_outer, u_inner, bcs):
    """Overwrite the boundary rows of ``u_outer`` (a tensor this module made,
    never the caller's) with the ghost states of the inner states
    ``u_inner``, one BC per label group; ``u_inner`` is only read, since it
    also enters the flux.  Returns ``u_outer``.

    Every boundary label that has faces must have a BC entry, as the
    reference wires one per label (``SkunkFvSolver.hpp:73-74``).
    """
    ranges = dmesh.face_label_ranges
    missing = [label for label in range(1, len(ranges) - 1)
               if ranges[label + 1] > ranges[label] and label not in bcs]
    if missing:
        raise StormError(
            f"boundary labels {missing} have faces but no boundary condition;"
            " pass a BC for every label (reference SkunkFvSolver.hpp:73-74)"
        )
    for label, bc in bcs.items():
        lo, hi = ranges[label], ranges[label + 1]
        if hi <= lo:
            continue
        u_outer[lo:hi] = bc(dmesh.face_normals[lo:hi], dmesh.face_centers[lo:hi],
                            u_inner[lo:hi])
    return u_outer


def upwind_convection(dmesh, u, bcs, flux_scheme=lax_friedrichs_flux):
    """1st-order upwind convection (ConvectionScheme.hpp:57-109).

    ``u``: (num_cells, nv) conserved states; ``bcs``: {label: bc_fn}.
    Returns div_f (num_cells, nv).
    """
    u_inner, u_outer = _face_states(dmesh, u)  # (num_faces, nv)
    u_outer = _set_boundary_ghosts(dmesh, u_outer, u_inner, bcs)
    flux = flux_scheme(dmesh.face_normals, u_outer, u_inner)
    return _accumulate(dmesh, flux)


def linear_upwind_convection(dmesh, u, bcs, flux_scheme=lax_friedrichs_flux, *, g_mats=None,
                             slope_limiter=cubic_limiter,
                             second_limiter=cubic_second_limiter):
    """2nd-order limited upwind convection (ConvectionScheme.hpp:113-198).

    Gradients (LSQ) → limiters → limited linear face reconstruction →
    flux → gather-accumulate.
    """
    if g_mats is None:
        g_mats = lsq_gradient_matrices(dmesh)
    grad_u = lsq_gradients(dmesh, u, g_mats)  # (n, nv, d)
    lim_u = compute_limiters(dmesh, u, grad_u, slope_limiter=slope_limiter,
                             second_limiter=second_limiter)
    grad_u = grad_u * lim_u[..., None]  # :146-148

    # Face reconstruction u ± ∇u·dr (:161-169).
    grad_flat = grad_u.reshape(dmesh.num_cells, -1)
    if dmesh.bg_face_inner is not None:
        cc_inner = dmesh.bg_face_inner(dmesh.cell_centers)
        cc_outer = dmesh.bg_face_outer(dmesh.cell_centers)
        gi = dmesh.bg_face_inner(grad_flat)
        go = dmesh.bg_face_outer(grad_flat)
    else:
        outer_idx = torch.clamp(dmesh.face_outer, min=0)
        cc_inner = dmesh.cell_centers[dmesh.face_inner]
        cc_outer = dmesh.cell_centers[outer_idx]
        gi = grad_flat[dmesh.face_inner]
        go = grad_flat[outer_idx]
    grad_i = gi.reshape((-1,) + tuple(grad_u.shape[1:]))
    grad_o = go.reshape((-1,) + tuple(grad_u.shape[1:]))
    ui0, uo0 = _face_states(dmesh, u)
    dr_inner = dmesh.face_centers - cc_inner
    dr_outer = dmesh.face_centers - cc_outer
    u_inner = ui0 + (grad_i * dr_inner[:, None, :]).sum(-1)
    u_outer = uo0 + (grad_o * dr_outer[:, None, :]).sum(-1)

    # Boundary ghosts from the *reconstructed* inner state (:177-189).
    u_outer = _set_boundary_ghosts(dmesh, u_outer, u_inner, bcs)

    flux = flux_scheme(dmesh.face_normals, u_outer, u_inner)
    return _accumulate(dmesh, flux)
