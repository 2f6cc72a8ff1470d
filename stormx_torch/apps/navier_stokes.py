"""Incompressible Navier–Stokes by Chorin pressure projection, serial
(counterpart of ``stormx/apps/navier_stokes.py``, BASELINE config #5):

  1. predictor  u* = u + dt·(−(u·∇)u + ν ∇²u), LSQ gradients for the
     convective term and ``div_grad`` for the viscous one;
  2. pressure Poisson  ∇²p = div(u*)/dt on the assembled div-grad operator
     (an ``ELL`` on the mesh's device), solved by :func:`solve`;
  3. corrector  u = u* − dt·∇p, and the face fluxes corrected by the
     two-point pressure-gradient flux.

The JAX package gathers the face states and the flux divergence with XLA;
here every gather goes through K3 when the mesh carries its plans (the same
values, bit for bit).  With ``num_parts > 1`` the pressure solve is
partitioned over the ranks of a ``RankMesh`` (``sharded_solve``); every rank
steps the same global velocity and gets the global pressure back.
``stormx_torch.parallel.ns.ShardedNsProjection`` distributes the whole step.
"""

from __future__ import annotations

import torch

from stormx_torch.fvm.convection import _face_states
from stormx_torch.fvm.divgrad import assemble_divgrad, div_grad
from stormx_torch.fvm.gradient import lsq_gradient_matrices, lsq_gradients
from stormx_torch.sparse.formats import ELL

__all__ = ["NsProjection", "cell_divergence", "face_fluxes", "flux_divergence"]


def face_fluxes(dmesh, vel):
    """Face normal volume fluxes F_f = v_face·n̂·A from cell velocities
    (central average; boundary faces use the inner value)."""
    v_in, v_out = _face_states(dmesh, vel)
    bdry = (dmesh.face_outer < 0)[:, None]
    v_face = torch.where(bdry, v_in, 0.5 * (v_in + v_out))
    return (v_face * dmesh.face_normals).sum(-1) * dmesh.face_areas


def flux_divergence(dmesh, flux):
    """div per cell from face fluxes, the gather-accumulate of the
    convection operator."""
    if dmesh.bg_cell_face is not None:
        g = dmesh.bg_cell_face(flux).reshape(dmesh.cell_face_ell.shape)
    else:
        g = flux[dmesh.cell_face_ell]
    acc = torch.sum(dmesh.cell_face_sign * g, dim=1)
    return acc / dmesh.cell_volumes


def cell_divergence(dmesh, vel):
    """div(v) per cell from face-averaged normal fluxes."""
    return flux_divergence(dmesh, face_fluxes(dmesh, vel))


class NsProjection:
    """Chorin projection stepper on an unstructured mesh.

    ``mesh``: host :class:`~stormx_torch.mesh.UnstructuredMesh`; ``nu``:
    kinematic viscosity; ``method``: the Krylov method of the pressure
    solve.  The fields live on ``device`` in ``dtype`` (float32 unless the
    caller asks), the card unless the caller asks for the CPU;
    ``banded_gather`` is passed to ``device_arrays``.  ``num_parts > 1``
    partitions the pressure Poisson solve over the ranks of
    ``device_mesh`` (this rank's ``RankMesh``; by default
    ``make_device_mesh`` on the default group), whose device must be
    ``device``.
    """

    def __init__(self, mesh, *, nu: float = 1e-2, num_parts: int = 1, method: str = "idrs",
                 solver_kw: dict | None = None, banded_gather: bool | None = None,
                 dtype=None, device="cuda", device_mesh=None):
        self.dmesh = mesh.device_arrays(dtype, device=device, banded_gather=banded_gather)
        self.nu = nu
        self.method = method
        self.solver_kw = dict(solver_kw or {})
        self.num_parts = num_parts
        self._g_mats = lsq_gradient_matrices(self.dmesh)
        ell = assemble_divgrad(mesh)  # weighted Laplacian, host float64
        real = self.dmesh.cell_volumes
        self._poisson = ELL(data=ell.data.to(device=real.device, dtype=real.dtype),
                            cols=ell.cols.to(real.device), shape=ell.shape)
        if num_parts > 1:
            from stormx_torch.parallel import partition_csr
            from stormx_torch.parallel.sharded import _mesh_for

            self._pmesh = _mesh_for(num_parts, device_mesh)
            self._pop = partition_csr(self._poisson.to_csr(), num_parts, device="cpu")

    # -- substeps -----------------------------------------------------------

    def predictor(self, vel, dt):
        """u* = u + dt·(−(u·∇)u + ν ∇²u)."""
        grads = lsq_gradients(self.dmesh, vel, g_mats=self._g_mats)
        # (u·∇)u per cell: (n, dim_out) = Σ_d u_d ∂u_out/∂x_d.
        conv = (vel[:, None, :] * grads).sum(-1)
        visc = torch.stack(
            [div_grad(self.dmesh, torch.zeros_like(vel[:, d]), self.nu, vel[:, d])
             for d in range(vel.shape[1])],
            dim=1,
        )
        return vel + dt * (visc - conv)

    def pressure_solve(self, rhs):
        """Solve ∇²p = rhs (mean-free), serial or partitioned."""
        rhs = rhs - torch.mean(rhs)  # compatibility with the constant nullspace
        if self.num_parts > 1:
            from stormx_torch.parallel import sharded_solve

            res = sharded_solve(self._pop, rhs, mesh=self._pmesh, method=self.method,
                                **self.solver_kw)
        else:
            from stormx_torch.solvers import solve

            res = solve(self._poisson, rhs, method=self.method, **self.solver_kw)
        p = res.x - torch.mean(res.x)
        return p, res

    def correct_fluxes(self, flux, p, dt):
        """F ← F − dt·A·(p_out − p_in)/dist on interior faces: the stencil
        of the assembled Poisson operator, so ``flux_divergence`` of the
        result equals the residual of the pressure solve."""
        d = self.dmesh
        interior = d.face_outer >= 0
        p_in, p_out = _face_states(d, p)
        dist = torch.where(d.face_dist > 0, d.face_dist, 1.0)
        corr = torch.where(interior, d.face_areas * (p_out - p_in) / dist, 0.0)
        return flux - dt * corr

    def step(self, vel, dt):
        """One projection step; returns (vel', p, result, corrected fluxes).

        The corrected face fluxes are divergence-free to solver tolerance;
        the corrected cell velocities use the LSQ pressure gradient and are
        only approximately solenoidal (collocated grid).
        """
        v_star = self.predictor(vel, dt)
        flux = face_fluxes(self.dmesh, v_star)
        div = flux_divergence(self.dmesh, flux)
        p, res = self.pressure_solve(div / dt)
        flux_new = self.correct_fluxes(flux, p, dt)
        grad_p = lsq_gradients(self.dmesh, p, g_mats=self._g_mats)
        vel_new = v_star - dt * grad_p
        return vel_new, p, res, flux_new
