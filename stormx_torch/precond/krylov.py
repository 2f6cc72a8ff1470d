"""Krylov (inner-solver) preconditioner (counterpart of
``stormx/precond/krylov.py``).

M⁻¹r is approximated by a few iterations of an inner Krylov solver on
𝓐z = r.  The inner iteration count depends on r, so the map r ↦ z is
*nonlinear*: pair it with a flexible outer method (FGMRES), as the
reference's "Flexible = Yes" column prescribes.
"""

from __future__ import annotations

from stormx_torch.solvers.preconditioner import Preconditioner

__all__ = ["KrylovPreconditioner"]


class KrylovPreconditioner(Preconditioner):
    """M⁻¹ ≈ a fixed-budget inner Krylov solve of 𝓐z = r.

    ``method`` is any name from ``stormx_torch.solvers.SOLVERS``;
    ``num_iterations`` caps the inner work (default 8);
    ``relative_tolerance`` lets well-conditioned residuals exit early
    (default 1e-2 — loose, it is only a preconditioner).
    """

    def __init__(self, op=None, *, method: str = "cg", num_iterations: int = 8,
                 relative_tolerance: float = 1.0e-2, inner_precond=None,
                 axis_name: str | None = None):
        self._op = op
        self._method = method
        self._inner_iters = num_iterations
        self._rtol = relative_tolerance
        self._inner_precond = inner_precond
        self._axis_name = axis_name

    def build(self, x, b, op):
        if self._op is None:
            self._op = op
        return self

    def with_axis_name(self, axis_name):
        """A copy whose inner reductions reduce over ``axis_name``; the
        user's preconditioner is never mutated."""
        return KrylovPreconditioner(
            self._op,
            method=self._method,
            num_iterations=self._inner_iters,
            relative_tolerance=self._rtol,
            inner_precond=self._inner_precond,
            axis_name=axis_name,
        )

    def __call__(self, r):
        from stormx_torch.ops import vector as v
        from stormx_torch.solvers import SOLVERS
        from stormx_torch.solvers.base import SolverOptions

        if self._op is None:
            raise ValueError(
                "KrylovPreconditioner has no operator; pass one or let the "
                "outer solver call build()"
            )
        options = SolverOptions(
            num_iterations=self._inner_iters,
            absolute_tolerance=0.0,
            relative_tolerance=self._rtol,
            record_history=False,
        )
        kwargs = {"options": options}
        if self._inner_precond is not None:
            kwargs["precond"] = self._inner_precond
        if self._axis_name is not None:
            kwargs["axis_name"] = self._axis_name
        result = SOLVERS[self._method](self._op, r, v.zeros_like(r), **kwargs)
        return result.x

    def conj_apply(self, r):
        raise NotImplementedError(
            "Krylov preconditioning is nonlinear; no adjoint apply exists — "
            "use it with a flexible method (FGMRES)"
        )
