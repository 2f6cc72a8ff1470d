"""TFQMR (Freund, L2) and TFQMR1 (Bücker, L1) (counterpart of
``stormx/solvers/tfqmr.py``; reference ``BaseTfqmrSolver<Vector, L1>``,
``Solvers/SolverTfqmr.hpp:37-215``): two operator products per iteration,
the inner m = 0, 1 half-steps unrolled, ``sym_ortho`` for the L2
quasi-minimization, and the ×√(2k+3) residual upper-bound estimate for L2
(``:202-206``).  TFQMR1's "keep the better iterate" test stays on the
device (``torch.where``).
"""

from __future__ import annotations

import math

import torch

from stormx_torch.ops import safe_divide, sym_ortho
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["tfqmr", "tfqmr1"]


def _base_tfqmr(op, b, x0, *, l1: bool, precond, options: SolverOptions | None,
                axis_name) -> SolveResult:
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="tfqmr")
    left_pre = P is not None and side == PreconditionerSide.LEFT
    right_pre = P is not None and side == PreconditionerSide.RIGHT

    def dot(a, c):
        return v.dot(a, c, axis_name=axis_name)

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def product(y):
        """s ← 𝓟(𝓐y) | 𝓐(𝓟y) | 𝓐y; returns (s, z) with z = 𝓟y for RightPre."""
        if left_pre:
            return P(A(y)), y
        if right_pre:
            z = P(y)
            return A(z), z
        return A(y), y

    def init_fn(x):
        # d ← x (L1) | 0; y ← 𝓟?(b − 𝓐x); u ← y; r̃ ← u; ρ ← <r̃⋅u>; τ ← √ρ
        # (SolverTfqmr.hpp:58-88).
        y = A.residual(b, x)
        if left_pre:
            y = P(y)
        d = x if l1 else v.zeros_like(x)
        u = y
        r_tilde = u
        rho = dot(u, r_tilde)
        tau = torch.sqrt(torch.real(rho))
        zeros = v.zeros_like(y)
        # state: (d, r_tilde, u, v_vec, y, s_vec, rho, tau)
        return (d, r_tilde, u, zeros, y, zeros, rho, tau), tau

    def iterate_fn(it, x, state):
        d, r_tilde, u, vv, y, s, rho, tau = state

        # v/y/s update (:99-142).
        if it == 0:
            s, z = product(y)
            vv = s
        else:
            rho_new = dot(u, r_tilde)
            beta = safe_divide(rho_new, rho)
            vv1 = v.xpay(s, beta, vv)
            y = v.xpay(u, beta, y)
            s, z = product(y)
            vv = v.xpay(s, beta, vv1)
            rho = rho_new

        # α ← ρ/<r̃⋅v>; two half-steps m = 0, 1 (:144-192).
        alpha = safe_divide(rho, dot(vv, r_tilde))
        for mm in (0, 1):
            u = v.xpay(u, -alpha, s)
            d = v.xpay(d, alpha, z if right_pre else y)
            omega = norm(u)
            if l1:
                better = omega < tau
                tau = torch.where(better, omega, tau)
                x = v.tree_where(better, d, x)
            else:
                cs, sn, _ = sym_ortho(tau, omega)
                tau = omega * cs
                x = v.xpay(x, cs**2, d)
                d = v.scale(sn**2, d)
            if mm == 0:
                y = v.xpay(y, -alpha, vv)
                s, z = product(y)

        # Residual norm or its L2 upper bound (:194-208).
        err = tau if l1 else tau * math.sqrt(2.0 * it + 3.0)
        return x, (d, r_tilde, u, vv, y, s, rho, tau), err

    return run_iterative(init_fn, iterate_fn, None, x0, opts)


def tfqmr(op, b, x0, *, precond=None, options: SolverOptions | None = None,
          axis_name=None) -> SolveResult:
    """TFQMR (L2 quasi-minimization; ``SolverTfqmr.hpp:243-244``)."""
    return _base_tfqmr(op, b, x0, l1=False, precond=precond, options=options,
                       axis_name=axis_name)


def tfqmr1(op, b, x0, *, precond=None, options: SolverOptions | None = None,
           axis_name=None) -> SolveResult:
    """TFQMR1 (L1 variant with implicit residual norm; ``:264-265``)."""
    return _base_tfqmr(op, b, x0, l1=True, precond=precond, options=options,
                       axis_name=axis_name)
