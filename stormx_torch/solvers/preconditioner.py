"""Preconditioner protocol and sides (counterpart of
``stormx/solvers/preconditioner.py``; reference ``Solvers/Preconditioner.hpp:39-97``).
"""

from __future__ import annotations

import enum
from typing import Callable

__all__ = [
    "PreconditionerSide",
    "Preconditioner",
    "IdentityPreconditioner",
    "FunctionPreconditioner",
    "build_preconditioner",
]


class PreconditionerSide(enum.Enum):
    """Default side is Right (``Solver.hpp:74``)."""

    LEFT = "left"
    RIGHT = "right"
    SYMMETRIC = "symmetric"


class Preconditioner:
    """P ≈ 𝓐⁻¹ applied as a function of a tensor."""

    def build(self, x, b, op) -> "Preconditioner":
        """Prepare for solving 𝓐x = b.  Returns self."""
        return self

    def __call__(self, x):
        raise NotImplementedError

    def conj_apply(self, x):
        """The adjoint apply 𝓟*(x), which LSQR and LSMR need."""
        raise NotImplementedError


class IdentityPreconditioner(Preconditioner):
    """Debug identity preconditioner (reference ``Preconditioner.hpp:79-97``)."""

    def __call__(self, x):
        return x

    def conj_apply(self, x):
        return x


class FunctionPreconditioner(Preconditioner):
    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, x):
        return self._fn(x)


def build_preconditioner(precond, x, b, op):
    """Normalize the user-supplied preconditioner and run its build phase
    (reference ``Solver.hpp:119-121``)."""
    if precond is None:
        return None
    if isinstance(precond, Preconditioner):
        return precond.build(x, b, op)
    if callable(precond):
        return FunctionPreconditioner(precond)
    raise TypeError(f"cannot interpret {type(precond)!r} as a preconditioner")
