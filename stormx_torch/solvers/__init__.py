"""Krylov solver driver and CG (the rest of ``stormx/solvers`` waits for a
later slice)."""

from stormx_torch.solvers.base import SolveResult, SolverOptions, run_iterative
from stormx_torch.solvers.cg import cg
from stormx_torch.solvers.operator import LinearOperator, as_operator, make_operator
from stormx_torch.solvers.preconditioner import (
    Preconditioner,
    PreconditionerSide,
    build_preconditioner,
)

__all__ = [
    "SolveResult",
    "SolverOptions",
    "run_iterative",
    "LinearOperator",
    "as_operator",
    "make_operator",
    "Preconditioner",
    "PreconditionerSide",
    "build_preconditioner",
    "cg",
]
