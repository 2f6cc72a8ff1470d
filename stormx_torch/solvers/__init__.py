"""Krylov solver suite (counterpart of ``stormx/solvers``; reference
``source/Storm/Solvers/``).

Every solver is a function ``solver(op, b, x0, **kw) -> SolveResult``;
:func:`solve` picks one by name from :data:`SOLVERS`, which lists exactly
the methods ported so far: the Krylov methods, ``lgmres``/``lfgmres``, and
the nonlinear ``newton``/``jfnk``.  ``lsqr``/``lsmr`` wait for the
preconditioner slice, beside ``iqr``, their right preconditioner in the JAX
package, and for the adjoint product they need.
"""

from stormx_torch.ops import vector as _v
from stormx_torch.solvers.base import (
    SolveResult,
    SolverOptions,
    resolve_side,
    run_iterative,
)
from stormx_torch.solvers.bicgstab import bicgstab, bicgstab_l
from stormx_torch.solvers.cg import cg
from stormx_torch.solvers.cgs import cgs
from stormx_torch.solvers.gmres import fgmres, gmres
from stormx_torch.solvers.idrs import idrs
from stormx_torch.solvers.lgmres import lfgmres, lgmres
from stormx_torch.solvers.newton import jfnk, newton
from stormx_torch.solvers.operator import LinearOperator, as_operator, make_operator
from stormx_torch.solvers.preconditioner import (
    IdentityPreconditioner,
    Preconditioner,
    PreconditionerSide,
    build_preconditioner,
)
from stormx_torch.solvers.richardson import richardson
from stormx_torch.solvers.tfqmr import tfqmr, tfqmr1

SOLVERS = {
    "richardson": richardson,
    "cg": cg,
    "cgs": cgs,
    "bicgstab": bicgstab,
    "bicgstab_l": bicgstab_l,
    "tfqmr": tfqmr,
    "tfqmr1": tfqmr1,
    "idrs": idrs,
    "gmres": gmres,
    "fgmres": fgmres,
    "lgmres": lgmres,
    "lfgmres": lfgmres,
    "newton": newton,
    "jfnk": jfnk,
}


def solve(op, b, x0=None, *, method: str = "cg", **kwargs) -> SolveResult:
    """Solve 𝓐(x) = b (reference free-function ``solve``, ``Solver.hpp:261-265``)."""
    if x0 is None:
        x0 = _v.zeros_like(b)
    try:
        fn = SOLVERS[method.lower()]
    except KeyError:
        raise ValueError(
            f"unknown or not yet ported solver {method!r}; choose from {sorted(SOLVERS)}"
        ) from None
    return fn(op, b, x0, **kwargs)


def solve_non_uniform(op, b, x0, *, method: str = "cg", **kwargs) -> SolveResult:
    """Solve 𝓐(x) = b for an affine operator (𝓐(0) ≠ 0), reference
    ``Solver.hpp:271-292``: uniformize as [𝓐(x) − 𝓐(0)] = b − 𝓐(0)."""
    A = as_operator(op)
    z = A(_v.zeros_like(x0))
    f = _v.sub(b, z)
    uni_op = make_operator(lambda x: _v.sub(A(x), z))
    return solve(uni_op, f, x0, method=method, **kwargs)


__all__ = [
    "SolveResult",
    "SolverOptions",
    "run_iterative",
    "resolve_side",
    "LinearOperator",
    "as_operator",
    "make_operator",
    "Preconditioner",
    "PreconditionerSide",
    "IdentityPreconditioner",
    "build_preconditioner",
    "richardson",
    "cg",
    "cgs",
    "bicgstab",
    "bicgstab_l",
    "tfqmr",
    "tfqmr1",
    "idrs",
    "gmres",
    "fgmres",
    "lgmres",
    "lfgmres",
    "newton",
    "jfnk",
    "solve",
    "solve_non_uniform",
    "SOLVERS",
]
