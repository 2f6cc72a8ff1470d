"""Richardson iteration (counterpart of ``stormx/solvers/richardson.py``;
reference ``Solvers/SolverRichardson.hpp:41-98``).

x ← x + ω·r with r = 𝓟(b − 𝓐x); fixed relaxation factor ω = 1e-4 by
default (reference ``:45``).  With ω = 1 and a multigrid 𝓟 it is the
stationary V-cycle iteration.
"""

from __future__ import annotations

from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import build_preconditioner

__all__ = ["richardson"]


def richardson(op, b, x0, *, precond=None, options: SolverOptions | None = None,
               relaxation_factor: float = 1.0e-4, axis_name=None) -> SolveResult:
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)

    def apply_p(r):
        # r ← 𝓟r regardless of side (reference :65-69).
        return P(r) if P is not None else r

    def init_fn(x):
        r = apply_p(A.residual(b, x))
        return (r,), v.norm_2(r, axis_name=axis_name)

    def iterate_fn(it, x, state):
        (r,) = state
        x = v.xpay(x, relaxation_factor, r)
        r = apply_p(A.residual(b, x))
        return x, (r,), v.norm_2(r, axis_name=axis_name)

    return run_iterative(init_fn, iterate_fn, None, x0, opts)
