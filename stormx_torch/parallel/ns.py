"""The whole Navier–Stokes projection step distributed over ranks
(counterpart of ``stormx/parallel/ns.py``, BASELINE config #5:
"partitioned mesh across N ≥ 2 hosts, halo-overlapped SpMV, IDR(s) vs
BiCGStab(l)").

:class:`stormx_torch.apps.navier_stokes.NsProjection` distributes only the
pressure Poisson solve; here every part of the step — predictor (LSQ
convection + two-point viscous fluxes), divergence, pressure Krylov solve
and corrector — runs on each rank's slab:

* cells are block-partitioned in NATURAL order, shared between the FV halo
  tables (:class:`~stormx_torch.parallel.PartitionedFv`) and the Poisson
  operator (``partition_csr(..., reorder=False)``): both pad to the same
  ``n_loc = ceil(n/P)``, so vectors flow between the phases with no
  relayout;
* three halo all-gathers per step (the velocity for the predictor, u* for
  the face fluxes, p for the corrector) plus the Krylov loop's own
  collectives, and one all-gather of the results;
* every face and cell gather goes through the rank's K3 plans on the card
  (:meth:`PartitionedFv.local_mesh`);
* every per-cell accumulation keeps the serial per-row order; only the
  pressure Krylov dots and the two mean reductions change their grouping
  (local sum + all-reduce), the ~1e-15-per-iteration wobble every sharded
  solve carries.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.core.config import default_real_dtype
from stormx_torch.fvm.divgrad import assemble_divgrad
from stormx_torch.fvm.gradient import lsq_gradient_matrices, lsq_gradients
from stormx_torch.ops.math import safe_divide
from stormx_torch.parallel.fvm import halo_exchange, partition_fv
from stormx_torch.parallel.partition import partition_csr
from stormx_torch.parallel.sharded import _mesh_for, _orthog_default
from stormx_torch.solvers import SOLVERS, SolverOptions, make_operator

__all__ = ["ShardedNsProjection"]

# Keys of ``solver_kw`` the step reads itself; the rest go to the solver.
_OWN_KEYS = ("options", "shadow_seed")


class ShardedNsProjection:
    """Chorin projection with the ENTIRE step distributed over the ranks of
    ``device_mesh`` (a :class:`~stormx_torch.parallel.comm.RankMesh`;
    default :func:`make_device_mesh` on the default group).

    Distributed counterpart of
    :class:`stormx_torch.apps.navier_stokes.NsProjection`: ``step(vel,
    dt)`` takes the global (n, dim) velocity on every rank and returns
    ``(vel', p, result)`` in global layout on every rank.  The fields are in
    ``dtype`` (float32 unless the caller asks) on the rank's device.
    ``solver_kw`` may hold ``options`` and IDR(s)'s ``shadow_seed``; both
    are read, never removed, so building the step again gives the same
    step.
    """

    def __init__(self, mesh, *, nu: float = 1e-2, num_parts: int, method: str = "idrs",
                 device_mesh=None, solver_kw: dict | None = None, dtype=None):
        self.mesh = _mesh_for(num_parts, device_mesh)
        dtype = dtype or default_real_dtype()
        self.dmesh = mesh.device_arrays(dtype, device=self.mesh.device, banded_gather=False)
        self.nu = nu
        self.method = method.lower()
        self.solver_kw = dict(solver_kw or {})
        self.num_parts = num_parts

        # FV halo tables and the Poisson operator share the natural-order
        # block layout (both pad to n_loc = ceil(n/P)).
        self.pfv = partition_fv(self.dmesh, num_parts, halo_depth=2)
        poisson = assemble_divgrad(mesh).to_csr()
        poisson = type(poisson)(data=poisson.data.to(dtype), indices=poisson.indices,
                                row_ptr=poisson.row_ptr, shape=poisson.shape)
        self.pop = partition_csr(poisson, num_parts, reorder=False, device="cpu")
        assert self.pop.n_pad == self.pfv.n_loc, "layout mismatch"
        n, n_loc = self.pfv.n_global, self.pfv.n_loc
        r, dev = self.mesh.rank, self.mesh.device
        real = torch.zeros(num_parts * n_loc, dtype=torch.bool)
        real[:n] = True
        self._real = real.reshape(num_parts, n_loc)[r].to(dev)
        self._shadow = None
        if self.method == "idrs":
            # Global-layout shadow space: rank-local draws would make the
            # history depend on the partition count.
            from stormx_torch.solvers.idrs import _SHADOW_SEED

            s = self.solver_kw.get("s", 4)
            seed = self.solver_kw.get("shadow_seed", _SHADOW_SEED)
            raws = np.random.default_rng(seed).standard_normal((s - 1, n))
            raws = np.pad(raws, ((0, 0), (0, num_parts * n_loc - n)))
            self._shadow = torch.as_tensor(
                raws.reshape(s - 1, num_parts, n_loc)[:, r], device=dev).to(dtype)
        self._step = None

    # ------------------------------------------------------------------
    def _build_step(self):
        pfv, mesh = self.pfv, self.mesh
        r, dev = mesh.rank, mesh.device
        n, n_loc = pfv.n_global, pfv.n_loc
        dtype, nu = self.dmesh.cell_volumes.dtype, self.nu
        solver_fn = SOLVERS[self.method]
        opts = self.solver_kw.get("options") or SolverOptions()
        kw = _orthog_default(self.method, {k: v for k, v in self.solver_kw.items()
                                           if k not in _OWN_KEYS})
        if self._shadow is not None:
            kw = dict(kw, shadow=self._shadow)
        op = make_operator(self.pop.local_matvec(mesh))
        real = self._real

        lm = pfv.local_mesh(r, dev, dtype)
        c_v, cs = lm.cell_volumes, lm.cell_face_sign
        f_n, f_a = lm.face_normals, lm.face_areas
        K = lm.cell_face_ell.shape[1]
        g_mats = lsq_gradient_matrices(lm)
        # Two-point flux coefficient: 0 on boundary and padded faces
        # (l_out == l_in ⇒ distance 0), as the serial face_dist.
        f_dist = torch.linalg.vector_norm(
            lm.bg_face_outer(lm.cell_centers) - lm.bg_face_inner(lm.cell_centers), dim=1)
        coef = safe_divide(f_a, f_dist)

        def cell_sum(face_values):
            """Σ over each cell's faces of sign·value, / volume."""
            g = lm.bg_cell_face(face_values).reshape((lm.num_cells, K)
                                                     + tuple(face_values.shape[1:]))
            sign = cs if face_values.dim() == 1 else cs[..., None]
            vol = c_v if face_values.dim() == 1 else c_v[:, None]
            return torch.sum(sign * g, dim=1) / vol

        def step(vel, dt):
            vel_loc = self.partition_velocity(vel)[r]

            # --- predictor: u* = u + dt·(ν∇²u − (u·∇)u) on owned cells ---
            vel_full = halo_exchange(lm, mesh, vel_loc)  # (c_max, dim)
            grads = lsq_gradients(lm, vel_full, g_mats)  # (c_max, dim, d)
            conv = (vel_full[:, None, :] * grads).sum(-1)[:n_loc]
            diff = lm.bg_face_outer(vel_full) - lm.bg_face_inner(vel_full)
            visc = cell_sum(nu * coef[:, None] * diff)[:n_loc]
            v_star = vel_loc + dt * (visc - conv)

            # --- divergence of u* from face fluxes -----------------------
            vs_full = halo_exchange(lm, mesh, v_star)
            v_face = 0.5 * (lm.bg_face_inner(vs_full) + lm.bg_face_outer(vs_full))
            flux = (v_face * f_n).sum(-1) * f_a
            div = cell_sum(flux)[:n_loc]

            # --- pressure Poisson: ∇²p = div/dt, mean-free ---------------
            rhs = torch.where(real, div / dt, 0.0)
            mean = mesh.all_reduce_sum(torch.sum(rhs)) / n
            rhs = torch.where(real, rhs - mean, 0.0)
            res = solver_fn(op, rhs, torch.zeros_like(rhs), options=opts, axis_name=mesh, **kw)
            p_mean = mesh.all_reduce_sum(torch.sum(torch.where(real, res.x, 0.0))) / n
            p = torch.where(real, res.x - p_mean, 0.0)

            # --- corrector: u = u* − dt·∇p -------------------------------
            grad_p = lsq_gradients(lm, halo_exchange(lm, mesh, p), g_mats)[:n_loc]
            vel_new = v_star - dt * grad_p

            # One all-gather of the three results.
            out = mesh.all_gather(torch.cat([vel_new, p[:, None], res.x[:, None]], dim=1))
            out = self.unpartition(out)
            d = vel_new.shape[1]
            return out[:, :d], out[:, d], res._replace(x=out[:, d + 1])

        return step

    # ------------------------------------------------------------------
    def partition_velocity(self, vel):
        """Global (n, dim) → (P, n_loc, dim) block layout, on the rank's
        device."""
        vel = (vel if isinstance(vel, torch.Tensor) else torch.as_tensor(np.asarray(vel)))
        vel = vel.to(self.mesh.device, self.dmesh.cell_volumes.dtype)
        n, d = vel.shape
        pad = self.num_parts * self.pfv.n_loc - n
        vp = torch.cat([vel, vel.new_zeros((pad, d))])
        return vp.reshape(self.num_parts, self.pfv.n_loc, d)

    def unpartition(self, xp):
        """(P, n_loc, ...) → global (n, ...)."""
        return xp.reshape((-1,) + tuple(xp.shape[2:]))[: self.pfv.n_global]

    def step(self, vel, dt):
        """One distributed projection step on a GLOBAL (n, dim) velocity.

        Returns ``(vel', p, result)`` in global layout.
        """
        if self._step is None:
            self._step = self._build_step()
        return self._step(vel, dt)
