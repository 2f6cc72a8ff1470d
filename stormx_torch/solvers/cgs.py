"""CGS, Conjugate Gradients Squared (counterpart of
``stormx/solvers/cgs.py``; reference ``Solvers/SolverCgs.hpp:50-176``),
with the left/right preconditioning plumbing.  The first-iteration branch
is a host branch on the iteration number.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["cgs"]


def cgs(op, b, x0, *, precond=None, options: SolverOptions | None = None,
        axis_name=None) -> SolveResult:
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="cgs")
    left_pre = P is not None and side == PreconditionerSide.LEFT
    right_pre = P is not None and side == PreconditionerSide.RIGHT

    def init_fn(x):
        # r ← b − 𝓐x; LeftPre: r ← 𝓟r; r̃ ← r; ρ ← <r̃⋅r> (:70-88).
        r = A.residual(b, x)
        if left_pre:
            r = P(r)
        r_tilde = r
        rho = v.dot(r, r_tilde, axis_name=axis_name)
        state = (r, r_tilde, v.zeros_like(r), v.zeros_like(r), rho)
        return state, torch.sqrt(torch.real(rho))

    def iterate_fn(it, x, state):
        r, r_tilde, p, q, rho = state

        # First iteration: u ← r, p ← u; else β-update (:99-122).
        if it == 0:
            u, p = r, r
        else:
            rho_new = v.dot(r, r_tilde, axis_name=axis_name)
            beta = safe_divide(rho_new, rho)
            u = v.xpay(r, beta, q)
            p = v.xpay(u, beta, v.xpay(q, beta, p))
            rho = rho_new

        # v ← 𝓐(𝓟p) | 𝓟(𝓐p) | 𝓐p; α ← ρ/<r̃⋅v>; q ← u − α·v; v ← u + q (:124-141).
        if left_pre:
            vv = P(A(p))
        elif right_pre:
            vv = A(P(p))
        else:
            vv = A(p)
        alpha = safe_divide(rho, v.dot(vv, r_tilde, axis_name=axis_name))
        q = v.xpay(u, -alpha, vv)
        vv = v.add(u, q)

        # Solution/residual update, side-dependent (:143-171).
        if left_pre:
            x = v.xpay(x, alpha, vv)
            r = v.xpay(r, -alpha, P(A(vv)))
        elif right_pre:
            u2 = P(vv)
            x = v.xpay(x, alpha, u2)
            r = v.xpay(r, -alpha, A(u2))
        else:
            x = v.xpay(x, alpha, vv)
            r = v.xpay(r, -alpha, A(vv))

        return x, (r, r_tilde, p, q, rho), v.norm_2(r, axis_name=axis_name)

    return run_iterative(init_fn, iterate_fn, None, x0, opts)
