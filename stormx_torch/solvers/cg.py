"""Conjugate Gradients (counterpart of ``stormx/solvers/cg.py``).

Recurrence transcribed from the reference pseudocode
(``Solvers/SolverCg.hpp:47-128``); the preconditioner is applied as z = 𝓟r
whatever ``pre_side`` says.  Per iteration: 1 operator product, 2 dot
products (+1 norm with a preconditioner).

The iteration is freezable (``run_iterative``'s graph path, for a solve
whose reductions stay on one device): frozen, α is 0, so x + 0·p and
r − 0·z leave x and r as they are, γ is recomputed from the same r, and p
stays finite (it grows by r at most once an iteration).
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import build_preconditioner

__all__ = ["cg"]


def cg(op, b, x0, *, precond=None, options: SolverOptions | None = None,
       axis_name=None) -> SolveResult:
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)

    def init_fn(x):
        # r ← b − 𝓐x; p ← (𝓟r | r); γ ← <r⋅z> (SolverCg.hpp:61-83).
        r = A.residual(b, x)
        if P is not None:
            z = P(r)
            p = z
            gamma = v.dot(r, z, axis_name=axis_name)
            err = v.norm_2(r, axis_name=axis_name)
        else:
            p = r
            gamma = v.dot(r, r, axis_name=axis_name)
            err = torch.sqrt(torch.real(gamma))
        return (p, r, gamma), err

    def iterate_fn(it, x, state, frozen=None):
        p, r, gamma = state
        # z ← 𝓐p; α ← γ/<p⋅z>; x += α·p; r −= α·z (SolverCg.hpp:89-99).
        z = A(p)
        alpha = safe_divide(gamma, v.dot(p, z, axis_name=axis_name))
        if frozen is not None:
            alpha = torch.where(frozen, 0.0, alpha)
        x = v.xpay(x, alpha, p)
        r = v.xpay(r, -alpha, z)

        gamma_bar = gamma
        if P is not None:
            z = P(r)
            gamma = v.dot(r, z, axis_name=axis_name)
        else:
            gamma = v.dot(r, r, axis_name=axis_name)

        beta = safe_divide(gamma, gamma_bar)
        p = v.xpay(z if P is not None else r, beta, p)

        err = (
            v.norm_2(r, axis_name=axis_name) if P is not None
            else torch.sqrt(torch.real(gamma))
        )
        return x, (p, r, gamma), err

    return run_iterative(init_fn, iterate_fn, None, x0, opts, freezable=axis_name is None)
