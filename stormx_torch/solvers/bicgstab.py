"""BiCGStab (van der Vorst) and BiCGStab(l) (Sleijpen–Fokkema)
(counterpart of ``stormx/solvers/bicgstab.py``; reference
``Solvers/SolverBiCgStab.hpp``):

* BiCGStab, ``:52-167``: 2 operator products + 4 dots per iteration.
* BiCGStab(l), ``:184-383``: inner-outer with l inner steps (default 2);
  BiCG sweep + minimal-residual polynomial part with τ/γ recurrences.

The JAX package masks its loops over the static range [0, l] on the traced
inner index j; here j is a host integer, so the loops run over [0, j].
The small MR-part scalars (τ, σ, γ) stay on the device.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["bicgstab", "bicgstab_l"]


def bicgstab(op, b, x0, *, precond=None, options: SolverOptions | None = None,
             axis_name=None) -> SolveResult:
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="bicgstab")
    left_pre = P is not None and side == PreconditionerSide.LEFT
    right_pre = P is not None and side == PreconditionerSide.RIGHT

    def init_fn(x):
        # r ← b − 𝓐x; LeftPre: r ← 𝓟r; r̃ ← r; ρ ← <r̃⋅r> (:72-90).
        r = A.residual(b, x)
        if left_pre:
            r = P(r)
        r_tilde = r
        rho = v.dot(r, r_tilde, axis_name=axis_name)
        zeros = v.zeros_like(r)
        one = torch.ones_like(rho)
        # state: (r, r_tilde, p, v_vec, alpha, rho, omega)
        return (r, r_tilde, zeros, zeros, one, rho, one), torch.sqrt(torch.real(rho))

    def iterate_fn(it, x, state):
        r, r_tilde, p, vv, alpha, rho, omega = state

        # p-update (:101-120).
        if it == 0:
            p = r
        else:
            rho_new = v.dot(r, r_tilde, axis_name=axis_name)
            beta = safe_divide(alpha * rho_new, omega * rho)
            p = v.xpay(r, beta, v.xpay(p, -omega, vv))
            rho = rho_new

        # v ← 𝓐/𝓟 chain; α ← ρ/<r̃⋅v>; x += α·(z|p); r −= α·v (:122-141).
        if left_pre:
            vv = P(A(p))
            z = p
        elif right_pre:
            z = P(p)
            vv = A(z)
        else:
            vv = A(p)
            z = p
        alpha = safe_divide(rho, v.dot(vv, r_tilde, axis_name=axis_name))
        x = v.xpay(x, alpha, z if right_pre else p)
        r = v.xpay(r, -alpha, vv)

        # t-step: ω ← <t⋅r>/<t⋅t>; x += ω·(z|r); r −= ω·t (:143-162).
        if left_pre:
            t = P(A(r))
            z2 = r
        elif right_pre:
            z2 = P(r)
            t = A(z2)
        else:
            t = A(r)
            z2 = r
        omega = safe_divide(v.dot(r, t, axis_name=axis_name), v.dot(t, t, axis_name=axis_name))
        x = v.xpay(x, omega, z2 if right_pre else r)
        r = v.xpay(r, -omega, t)

        return x, (r, r_tilde, p, vv, alpha, rho, omega), v.norm_2(r, axis_name=axis_name)

    return run_iterative(init_fn, iterate_fn, None, x0, opts)


def bicgstab_l(op, b, x0, *, precond=None, options: SolverOptions | None = None,
               l: int = 2, axis_name=None) -> SolveResult:  # noqa: E741
    """BiCGStab(l).  The preconditioner is always applied as 𝓟∘𝓐 (the
    reference uses the chained ``pre_op->mul(y, z, lin_op, x)`` form
    regardless of ``pre_side``; ``SolverBiCgStab.hpp:275-299``).

    R and U are (l+1, n) stacks updated in place."""
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)

    def PA(x):
        y = A(x)
        return P(y) if P is not None else y

    def dot(a, c):
        return v.dot(a, c, axis_name=axis_name)

    def init_fn(x):
        # u₀ ← 0; r₀ ← 𝓟(b − 𝓐x); r̃ ← r₀; ρ ← <r̃⋅r₀> (:213-233).
        r0 = A.residual(b, x)
        if P is not None:
            r0 = P(r0)
        r_tilde = r0
        rho = dot(r0, r_tilde)
        R = v.set_stacked(v.stacked_zeros(r0, l + 1), 0, r0)
        U = v.stacked_zeros(r0, l + 1)
        alpha = torch.zeros_like(rho)
        omega = torch.zeros_like(rho)
        return (R, U, r_tilde, alpha, rho, omega), torch.sqrt(torch.real(rho))

    def iterate_fn(it, x, state):
        R, U, r_tilde, alpha, rho, omega = state
        j = it % l

        # --- BiCG part (:242-283) ---
        if it == 0:
            v.set_stacked(U, 0, R[0])  # u₀ ← r₀
        else:
            rho_new = dot(R[j], r_tilde)
            beta = safe_divide(alpha * rho_new, rho)
            for i in range(j + 1):  # uᵢ ← rᵢ − β·uᵢ
                v.set_stacked(U, i, v.xpay(R[i], -beta, U[i]))
            rho = rho_new

        # uⱼ₊₁ ← 𝓟𝓐uⱼ; α ← ρ/<r̃⋅uⱼ₊₁>; rᵢ −= α·uᵢ₊₁ for i = 0..j.
        u_j1 = PA(U[j])
        v.set_stacked(U, j + 1, u_j1)
        alpha = safe_divide(rho, dot(u_j1, r_tilde))
        for i in range(j + 1):
            v.set_stacked(R, i, v.xpay(R[i], -alpha, U[i + 1]))

        # x += α·u₀; rⱼ₊₁ ← 𝓟𝓐rⱼ (:285-299).
        x = v.xpay(x, alpha, U[0])
        v.set_stacked(R, j + 1, PA(R[j]))

        # --- Minimal-residual part at j == l−1 (:301-372) ---
        if j == l - 1:
            x, rho, omega = _mr_part(x, R, U, rho, l, dot)

        err = v.norm_2(R[0], axis_name=axis_name)
        return x, (R, U, r_tilde, alpha, rho, omega), err

    return run_iterative(init_fn, iterate_fn, None, x0, opts)


def _mr_part(x, R, U, rho, l, dot):  # noqa: E741
    """The minimal-residual part of BiCGStab(l); updates R and U in place,
    returns (x, ρ, ω)."""
    zero = torch.zeros_like(rho)
    tau = [[zero] * (l + 1) for _ in range(l + 1)]
    sigma = [zero] * (l + 1)
    gamma_bar = [zero] * (l + 1)
    # MGS over r₁..r_l (:313-322).
    for jj in range(1, l + 1):
        r_jj = R[jj]
        for ii in range(1, jj):
            t_ij = safe_divide(dot(R[ii], r_jj), sigma[ii])
            tau[ii][jj] = t_ij
            r_jj = v.xpay(r_jj, -t_ij, R[ii])
        v.set_stacked(R, jj, r_jj)
        sigma[jj] = dot(r_jj, r_jj)
        gamma_bar[jj] = safe_divide(dot(R[0], r_jj), sigma[jj])
    # γ recurrences (:339-351).
    gamma = [zero] * (l + 1)
    gamma[l] = gamma_bar[l]
    omega = gamma_bar[l]
    rho = rho * (-omega)
    for jj in range(l - 1, 0, -1):
        acc = gamma_bar[jj]
        for ii in range(jj + 1, l + 1):
            acc = acc - tau[jj][ii] * gamma[ii]
        gamma[jj] = acc
    gamma_bbar = [zero] * (l + 1)
    for jj in range(1, l):
        acc = gamma[jj + 1]
        for ii in range(jj + 1, l):
            acc = acc + tau[jj][ii] * gamma[ii + 1]
        gamma_bbar[jj] = acc
    # Solution/residual/search-direction updates (:353-371).
    x = v.xpay(x, gamma[1], R[0])
    r0 = v.xpay(R[0], -gamma_bar[l], R[l])
    u0 = v.xpay(U[0], -gamma[l], U[l])
    for jj in range(1, l):
        x = v.xpay(x, gamma_bbar[jj], R[jj])
        r0 = v.xpay(r0, -gamma_bar[jj], R[jj])
        u0 = v.xpay(u0, -gamma[jj], U[jj])
    v.set_stacked(R, 0, r0)
    v.set_stacked(U, 0, u0)
    return x, rho, omega
