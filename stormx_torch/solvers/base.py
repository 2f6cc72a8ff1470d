"""Shared iterative-solver driver (counterpart of ``stormx/solvers/base.py``).

The reference's template-method convergence loop
(``Solvers/Solver.hpp:116-147``), as a Python loop over tensors:

  1. ``init`` → initial residual norm; ``absolute_error = initial_error``.
  2. Pre-loop early exit: if ``atol > 0 and abs_err < atol`` the loop body
     never runs (zero iterations).
  3. Up to ``num_iterations`` iterations: ``iterate`` returns the residual
     norm; converged when ``(atol > 0 and abs < atol) or (rtol > 0 and
     rel < rtol)`` with ``rel = abs / initial``, compared in the error's
     dtype.
  4. ``finalize`` runs once after the loop, and is skipped when zero
     iterations ran (the JAX package's documented deviation from the
     reference).

The history is the ``(num_iterations + 1,)`` NaN-padded array of absolute
errors.  The convergence test reads one boolean back to the host per
iteration (the ``lax.while_loop`` of the JAX package keeps it on the
device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from stormx_torch.core.exceptions import StormError
from stormx_torch.solvers.preconditioner import PreconditionerSide

__all__ = ["SolverOptions", "SolveResult", "run_iterative", "resolve_side"]


@dataclass(frozen=True)
class SolverOptions:
    """Knobs with the reference's names and defaults (``Solver.hpp:66-76,158-159``)."""

    num_iterations: int = 2000
    absolute_tolerance: float = 1.0e-6
    relative_tolerance: float = 1.0e-6
    pre_side: PreconditionerSide | str = PreconditionerSide.RIGHT
    record_history: bool = True


class SolveResult(NamedTuple):
    x: torch.Tensor
    converged: bool
    num_iterations: int  # executed iteration count
    absolute_error: torch.Tensor
    relative_error: torch.Tensor
    history: torch.Tensor | None  # (num_iterations + 1,) abs errors, NaN padded


def resolve_side(side, *, precond=None, solver: str | None = None) -> PreconditionerSide:
    """Normalize ``pre_side``; reject the unimplemented SYMMETRIC side when a
    preconditioner is supplied (no solver implements a split M = M_L·M_R;
    CG, whose z = 𝓟r recurrence is the symmetric iteration for SPD 𝓟,
    does not call this)."""
    if not isinstance(side, PreconditionerSide):
        side = PreconditionerSide(str(side).lower())
    if side is PreconditionerSide.SYMMETRIC and precond is not None:
        raise StormError(
            f"pre_side='symmetric' is not implemented by {solver or 'this solver'}"
            " (a symmetric split M = M_L·M_R requires a factorized"
            " preconditioner); use 'left' or 'right' — or CG, whose z = 𝓟r"
            " recurrence is algebraically the symmetric-preconditioned"
            " iteration for SPD 𝓟"
        )
    return side


def run_iterative(
    init_fn: Callable,
    iterate_fn: Callable,
    finalize_fn: Callable | None,
    x0: torch.Tensor,
    options: SolverOptions,
) -> SolveResult:
    """Drive ``iterate_fn`` to convergence.

    ``init_fn(x) -> (state, initial_error)``;
    ``iterate_fn(iteration, x, state) -> (x, state, abs_error)``;
    ``finalize_fn(executed_iterations, x, state) -> x`` (optional).
    """
    atol = options.absolute_tolerance
    rtol = options.relative_tolerance
    n_max = options.num_iterations

    state, initial_error = init_fn(x0)
    errors = [initial_error]
    converged = bool(atol > 0.0 and bool(initial_error < atol))
    x, abs_err = x0, initial_error
    rel_err = torch.ones_like(initial_error)
    it = 0
    while not converged and it < n_max:
        x, state, abs_err = iterate_fn(it, x, state)
        rel_err = abs_err / initial_error
        if atol > 0.0 and rtol > 0.0:
            converged = bool((abs_err < atol) | (rel_err < rtol))  # one host sync
        elif atol > 0.0:
            converged = bool(abs_err < atol)
        elif rtol > 0.0:
            converged = bool(rel_err < rtol)
        errors.append(abs_err)
        it += 1

    if finalize_fn is not None and it > 0:
        x = finalize_fn(it, x, state)

    history = None
    if options.record_history:
        history = torch.full(
            (n_max + 1,), float("nan"), dtype=initial_error.dtype,
            device=initial_error.device,
        )
        history[: it + 1] = torch.stack(errors)
    return SolveResult(
        x=x,
        converged=converged,
        num_iterations=it,
        absolute_error=abs_err,
        relative_error=rel_err,
        history=history,
    )
