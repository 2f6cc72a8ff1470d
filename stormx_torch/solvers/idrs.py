"""IDR(s), Induced Dimension Reduction (van Gijzen–Sonneveld, Algorithm 913)
(counterpart of ``stormx/solvers/idrs.py``; reference
``Solvers/SolverIdrs.hpp:52-291``): inner-outer with s inner steps
(default 4).

The shadow space is built once from the initial residual with modified
Gram–Schmidt over random vectors (``:129-141``).  They are drawn from a
``torch.Generator`` on the CPU seeded with the JAX package's pinned seed;
it gives other numbers than ``jax.random``, so a caller that needs the JAX
package's iterates passes the same ``shadow`` to both.  The inner index
k = iteration % s is a host integer, so the JAX package's masked loops over
[0, s) become loops over the live range.  The small state (φ, μ, ω) stays
on the device.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["idrs"]

_SHADOW_SEED = 20230815  # pinned shadow-space seed


def idrs(op, b, x0, *, precond=None, options: SolverOptions | None = None, s: int = 4,
         axis_name=None, shadow_seed: int = _SHADOW_SEED, shadow=None) -> SolveResult:
    """``shadow`` (optional): an (s−1, n) tensor of raw vectors used instead
    of random draws for p₁..pₛ₋₁."""
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="idrs")
    left_pre = P is not None and side == PreconditionerSide.LEFT
    right_pre = P is not None and side == PreconditionerSide.RIGHT

    def dot(a, c):
        return v.dot(a, c, axis_name=axis_name)

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def build_shadow_space(r, phi0):
        """p₀ = r/φ₀, then MGS-orthonormalized raw vectors (:109-141)."""
        Pspace = v.stacked_zeros(r, s)
        v.set_stacked(Pspace, 0, v.scale(safe_divide(1.0, phi0), r))
        gen = torch.Generator(device="cpu").manual_seed(shadow_seed)
        for i in range(1, s):
            if shadow is not None:
                p_i = torch.as_tensor(shadow[i - 1], dtype=r.dtype, device=r.device)
            else:
                p_i = torch.randn(r.shape, generator=gen, dtype=r.dtype).to(r.device)
            for j in range(i):
                p_j = Pspace[j]
                p_i = v.xpay(p_i, -dot(p_i, p_j), p_j)
            v.set_stacked(Pspace, i, v.scale(safe_divide(1.0, norm(p_i)), p_i))
        return Pspace

    def init_fn(x):
        # r ← 𝓟?(b − 𝓐x); φ₀ ← ‖r‖ (:85-101).
        r = A.residual(b, x)
        if left_pre:
            r = P(r)
        err0 = norm(r)
        phi = torch.zeros(s, dtype=r.dtype, device=r.device)
        phi[0] = err0
        mu = torch.eye(s, dtype=r.dtype, device=r.device)
        omega = torch.ones((), dtype=r.dtype, device=r.device)
        Pspace = build_shadow_space(r, phi[0])
        U = v.stacked_zeros(r, s)
        G = v.stacked_zeros(r, s)
        return (r, Pspace, U, G, phi, mu, omega), err0

    def iterate_fn(it, x, state):
        r, Pspace, U, G, phi, mu, omega = state
        k = it % s

        # inner_init at a cycle start (:104-147): φᵢ ← <r⋅pᵢ>, except at
        # it == 0, where init's (‖r₀‖, 0, …, 0) stands.
        if k == 0 and it > 0:
            phi = torch.stack([dot(r, Pspace[i]) for i in range(s)])

        # γ ← (μₖ:ₛ₋₁,ₖ:ₛ₋₁)⁻¹·φₖ:ₛ₋₁ by forward substitution (:160-173).
        gamma = [None] * s
        for i in range(k, s):
            acc = phi[i]
            for j in range(k, i):
                acc = acc - mu[i, j] * gamma[j]
            gamma[i] = safe_divide(acc, mu[i, i])
        coeffs = torch.zeros_like(phi)
        coeffs[k:] = torch.stack(gamma[k:])

        # v ← r − Σᵢ≥ₖ γᵢ·gᵢ; RightPre: v ← 𝓟v (:175-202).
        vvec = v.sub(r, v.lincomb_stacked(coeffs, G))
        if right_pre:
            vvec = P(vvec)

        # uₖ ← ω·v + Σᵢ≥ₖ γᵢ·uᵢ; gₖ ← 𝓟?𝓐uₖ (:203-211).
        u_k = v.axpy(omega, vvec, v.lincomb_stacked(coeffs, U))
        g_k = A(u_k)
        if left_pre:
            g_k = P(g_k)

        # Biorthogonalize against p₀..pₖ₋₁ (:213-226).
        for i in range(k):
            alpha = safe_divide(dot(g_k, Pspace[i]), mu[i, i])
            u_k = v.xpay(u_k, -alpha, U[i])
            g_k = v.xpay(g_k, -alpha, G[i])

        # New column of μ: μᵢₖ ← <pᵢ⋅gₖ> for i ≥ k; the entries above stay
        # stale, as in :234-236.
        mu = mu.clone()
        mu[k:, k] = torch.stack([dot(g_k, Pspace[i]) for i in range(k, s)])
        v.set_stacked(U, k, u_k)
        v.set_stacked(G, k, g_k)

        # β ← φₖ/μₖₖ; x += β·uₖ; r −= β·gₖ (:238-246).
        beta = safe_divide(phi[k], mu[k, k])
        x = v.xpay(x, beta, u_k)
        r = v.xpay(r, -beta, g_k)

        # φᵢ −= β·μᵢₖ for i > k (:248-256).
        phi = phi.clone()
        phi[k + 1:] = phi[k + 1:] - beta * mu[k + 1:, k]

        # At k == s−1: enter the next 𝒢 subspace (:258-280).
        if k == s - 1:
            if left_pre:
                v2 = P(A(r))
                z2 = r
            elif right_pre:
                z2 = P(r)
                v2 = A(z2)
            else:
                v2 = A(r)
                z2 = r
            omega = safe_divide(dot(r, v2), dot(v2, v2))
            x = v.xpay(x, omega, z2 if right_pre else r)
            r = v.xpay(r, -omega, v2)

        return x, (r, Pspace, U, G, phi, mu, omega), norm(r)

    return run_iterative(init_fn, iterate_fn, None, x0, opts)
