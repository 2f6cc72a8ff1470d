"""Slope limiters (Barth–Jespersen/minmod, Venkatakrishnan, Michalak cubic)
and second limiters (counterpart of ``stormx/fvm/limiter.py``; reference
``Feathers/GradientLimiterScheme.hpp:44-253``).

Each scalar limiter λ(du_min, du_max, du_face, ε²) is a branch-free
``torch.where`` chain over every (cell, face, var) at once, in the JAX
package's order; the per-cell min over faces (``:236-244``) is a masked min
over the cell←face table.  ε² = (0.1·V)³ (``:230-231``).  A Python number in
``torch.where`` takes the other operand's dtype, so float32 stays float32.
"""

from __future__ import annotations

import torch

from stormx_torch.fvm.gradient import gather_adjacent

__all__ = [
    "minmod_limiter",
    "venkatakrishnan_limiter",
    "cubic_limiter",
    "dummy_second_limiter",
    "cubic_second_limiter",
    "compute_limiters",
]


def _deltas(du_min, du_max, du_face):
    """delta_pos selection (GradientLimiterScheme.hpp:55-64 et al.)."""
    return torch.where(du_face < 0.0, du_min, du_max)


def minmod_limiter(du_min, du_max, du_face, eps_sqr):
    """min(1, Δ⁺/Δ⁻); 1 when Δ⁻ = 0 (:44-69)."""
    delta_pos = _deltas(du_min, du_max, du_face)
    safe = torch.where(du_face == 0.0, 1.0, du_face)
    y = delta_pos / safe
    return torch.where(du_face == 0.0, 1.0, torch.clamp(y, max=1.0))


def venkatakrishnan_limiter(du_min, du_max, du_face, eps_sqr):
    """Differentiable limiter (:72-102)."""
    delta_pos = _deltas(du_min, du_max, du_face)
    dp2 = delta_pos**2
    dn2 = du_face**2
    dpn = delta_pos * du_face
    lim = (dp2 + 2.0 * dpn + eps_sqr) / (dp2 + 2.0 * dn2 + dpn + eps_sqr)
    return torch.where(du_face == 0.0, 1.0, lim)


def cubic_limiter(du_min, du_max, du_face, eps_sqr):
    """Michalak Ollivier-Gooch cubic (:105-137)."""
    delta_pos = _deltas(du_min, du_max, du_face)
    safe = torch.where(du_face == 0.0, 1.0, du_face)
    y = delta_pos / safe
    y_thr = 1.75
    y_div = y / y_thr
    cub = y + y_div**2 * (3.0 - 2.0 * y_thr + (y_thr - 2.0) * y_div)
    lim = torch.where(y < y_thr, cub, 1.0)
    return torch.where(du_face == 0.0, 1.0, lim)


def dummy_second_limiter(limiter, du_min, du_max, eps_sqr):
    """Identity second limiter (:142-157)."""
    return limiter


def cubic_second_limiter(limiter, du_min, du_max, eps_sqr):
    """Disable limiting in smooth regions (:160-183)."""
    du_sqr = (du_max - du_min) ** 2
    dy = (du_sqr - eps_sqr) / eps_sqr
    weight = (2.0 * dy - 3.0) * dy**2 + 1.0
    blended = weight + (1.0 - weight) * limiter
    return torch.where(du_sqr <= eps_sqr, 1.0,
                       torch.where(du_sqr >= 2.0 * eps_sqr, limiter, blended))


def compute_limiters(dmesh, u, grad_u, *, slope_limiter=cubic_limiter,
                     second_limiter=cubic_second_limiter):
    """Per-cell limiter coefficients (GradientLimiterScheme.hpp:213-250).

    ``u``: (n,) or (n, nv); ``grad_u``: matching (n[, nv], dim).  The two
    gathers (adjacent states, incident face centers) go through K3 when the
    mesh carries plans.
    """
    scalar = u.dim() == 1
    if scalar:
        u = u[:, None]
        grad_u = grad_u[:, None, :]

    u_adj = gather_adjacent(dmesh, u)  # (n, K, nv)
    du_min = torch.clamp(torch.amin(u_adj, dim=1) - u, max=0.0)  # (n, nv)
    du_max = torch.clamp(torch.amax(u_adj, dim=1) - u, min=0.0)

    k = 0.1
    eps_sqr = ((k * dmesh.cell_volumes) ** 3)[:, None]  # (n, 1) — :230-231

    faces = dmesh.cell_face_ell  # (n, K) all incident faces
    mask = dmesh.cell_face_sign != 0
    if dmesh.bg_cell_face is not None:
        fc = dmesh.bg_cell_face(dmesh.face_centers).reshape(dmesh.num_cells, faces.shape[1], -1)
    else:
        fc = dmesh.face_centers[faces]
    dr = fc - dmesh.cell_centers[:, None, :]  # (n, K, d)
    du_face = (grad_u[:, None, :, :] * dr[:, :, None, :]).sum(-1)  # (n, Kf, nv)
    lim_face = slope_limiter(du_min[:, None, :], du_max[:, None, :], du_face,
                             eps_sqr[:, None, :])
    lim_face = torch.where(mask[..., None], lim_face, 1.0)
    lim = torch.clamp(torch.amin(lim_face, dim=1), max=1.0)  # (n, nv)

    lim = second_limiter(lim, du_min, du_max, eps_sqr)
    return lim[:, 0] if scalar else lim
