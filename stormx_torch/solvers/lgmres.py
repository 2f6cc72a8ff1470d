"""LGMRES and LFGMRES, restarted GMRES augmented with the last error
directions (counterpart of ``stormx/solvers/lgmres.py``; Baker, Jessup &
Manteuffel, SIMAX 26(4), 2005; reference ``README.md:66-67``, *Planned*).

LGMRES(m, k) builds each cycle an orthonormal basis of
``K_m(𝓐, r) + span{z_1..z_k}``, the z's being the last k normalized cycle
corrections ``x_end − x_start``: steps ``j < m`` multiply the Krylov vector
q_j, steps ``j ≥ m`` the stored error directions.  The first cycle, with no
z's yet, is plain GMRES(m+k).  LFGMRES is its flexible form: right
preconditioning with every step's direction z = 𝓟(d) stored.

The machinery is the port's GMRES (:mod:`stormx_torch.solvers.gmres`), whose
Arnoldi + Givens step and back-substitution it calls: an (m+k+1, n) basis
updated in place, Givens rotations and β on the device, a host inner index.  The count of valid augmentation vectors is a host integer
too, so a restart reads one boolean (``‖z‖ > 0``) back to the host.  The
back-substitution is ``solve_triangular``, as in the port's GMRES, where the
JAX package loops with ``safe_divide``: the two differ only when a diagonal
entry of H is exactly 0.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.gmres import arnoldi_step, back_substitute
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["lgmres", "lfgmres"]


def _base_lgmres(op, b, x0, *, flexible: bool, precond, options: SolverOptions | None,
                 restart: int, augment: int, axis_name, orthog: str = "mgs") -> SolveResult:
    if orthog not in ("mgs", "cgs2"):
        raise ValueError(f"unknown orthogonalization {orthog!r}")
    opts = options or SolverOptions()
    m, k_aug = restart, augment
    mm = m + k_aug  # inner steps per cycle
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="lgmres")
    left_pre = P is not None and not flexible and side == PreconditionerSide.LEFT
    right_pre = P is not None and (flexible or side == PreconditionerSide.RIGHT)
    store_z = flexible and P is not None

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def make_q0(x):
        q0 = A.residual(b, x)
        if left_pre:
            q0 = P(q0)
        beta0 = norm(q0)
        return v.scale(safe_divide(1.0, beta0), q0), beta0

    def init_fn(x):
        q0, beta0 = make_q0(x)
        Q = v.set_stacked(v.stacked_zeros(q0, mm + 1), 0, q0)
        Zaug = v.stacked_zeros(q0, max(k_aug, 1))
        Z = v.stacked_zeros(q0, mm) if store_z else None
        small = dict(dtype=q0.dtype, device=q0.device)
        H = torch.zeros((mm + 1, mm), **small)
        cs = torch.zeros(mm, **small)
        sn = torch.zeros(mm, **small)
        beta = torch.zeros(mm + 1, **small)
        beta[0] = beta0
        # nz: valid augmentation vectors (a host integer).
        return dict(Q=Q, Zaug=Zaug, Z=Z, H=H, cs=cs, sn=sn, beta=beta, x_start=x, nz=0), beta0

    def aug_slot(j, nz):
        """Step j multiplies Zaug[j − m] iff j ∈ [m, m + nz)."""
        return m <= j < m + nz

    def inner_iterate(j, x, s):
        Q, H, cs, sn, beta = s["Q"], s["H"], s["cs"], s["sn"], s["beta"]
        d = s["Zaug"][j - m] if aug_slot(j, s["nz"]) else Q[j]

        if left_pre:
            q_new = P(A(d))
        elif right_pre:
            z = P(d)
            q_new = A(z)
            if store_z:
                # Every step's x-space direction, Krylov and augmented alike.
                v.set_stacked(s["Z"], j, z)
        else:
            q_new = A(d)

        err = arnoldi_step(q_new, Q, j, H, cs, sn, beta, orthog=orthog, axis_name=axis_name,
                           safe=True)
        return x, s, err

    def correction(j, s):
        """The cycle's x-space correction after back-substitution."""
        y = back_substitute(s["H"], s["beta"], j)
        if store_z:
            return v.lincomb_stacked(y, s["Z"][: j + 1])
        aug = [aug_slot(i, s["nz"]) for i in range(j + 1)]
        kry = torch.tensor([not a for a in aug], device=y.device)
        delta = v.lincomb_stacked(torch.where(kry, y, 0.0), s["Q"][: j + 1])
        if any(aug):
            # Augmented part: y[m .. m+nz) on Zaug[0 .. nz).
            n_aug = sum(aug)
            delta = v.add(delta, v.lincomb_stacked(y[m : m + n_aug], s["Zaug"][:n_aug]))
        if right_pre:
            # A∘𝓟 was applied to every direction, Krylov and augmented, so 𝓟
            # applies to the whole combination.
            delta = P(delta)
        return delta

    def inner_finalize(j, x, s):
        return v.add(x, correction(j, s))

    def iterate_fn(it, x, s):
        j = it % mm
        if j == 0 and it > 0:
            # Restart: shift the finished cycle's normalized error direction
            # z = x − x_start into the augmentation stack.
            z_new = v.sub(x, s["x_start"])
            zn = norm(z_new)
            z_new = v.scale(safe_divide(1.0, zn), z_new)
            if k_aug > 0:
                s["Zaug"] = v.set_stacked(v.roll_stacked(s["Zaug"], 1), 0, z_new)
                s["nz"] = min(s["nz"] + int(bool(zn > 0)), k_aug)  # one host read
            q0, beta0 = make_q0(x)
            v.set_stacked(s["Q"], 0, q0)
            s["beta"].zero_()
            s["beta"][0] = beta0
            s["x_start"] = x
        x, s, err = inner_iterate(j, x, s)
        if j == mm - 1:
            x = inner_finalize(j, x, s)
        return x, s, err

    def finalize_fn(it, x, s):
        j_last = (it - 1) % mm
        return x if j_last == mm - 1 else inner_finalize(j_last, x, s)

    return run_iterative(init_fn, iterate_fn, finalize_fn, x0, opts)


def lgmres(op, b, x0, *, precond=None, options: SolverOptions | None = None, restart: int = 30,
           augment: int = 3, axis_name=None, orthog: str = "mgs") -> SolveResult:
    """LGMRES(m, k): restarted GMRES augmented with the last ``augment``
    error directions.  ``orthog``: "mgs" or "cgs2"."""
    return _base_lgmres(op, b, x0, flexible=False, precond=precond, options=options,
                        restart=restart, augment=augment, axis_name=axis_name, orthog=orthog)


def lfgmres(op, b, x0, *, precond=None, options: SolverOptions | None = None, restart: int = 30,
            augment: int = 3, axis_name=None, orthog: str = "mgs") -> SolveResult:
    """Flexible LGMRES: right preconditioning with every step's direction
    stored, so 𝓟 may vary between steps."""
    return _base_lgmres(op, b, x0, flexible=True, precond=precond, options=options,
                        restart=restart, augment=augment, axis_name=axis_name, orthog=orthog)
