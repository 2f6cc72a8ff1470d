"""Operator abstraction (counterpart of ``stormx/solvers/operator.py``;
reference ``Solvers/Operator.hpp:66-200``): a thin wrapper around a callable
``x ↦ A(x)`` on tensors.  The conjugate product waits for the first solver
that needs it.
"""

from __future__ import annotations

from typing import Callable

from stormx_torch.ops import vector as v

__all__ = ["LinearOperator", "make_operator", "as_operator"]


class LinearOperator:
    """Matrix-free operator y = A(x)."""

    def __init__(self, apply: Callable):
        self._apply = apply

    def __call__(self, x):
        return self._apply(x)

    def residual(self, b, x):
        """r = b − 𝓐(x) (reference ``Operator.hpp:95-99``)."""
        return v.sub(b, self(x))


def make_operator(apply) -> LinearOperator:
    """Wrap a callable into an operator (reference ``Operator.hpp:174-193``)."""
    return LinearOperator(apply)


def as_operator(op) -> LinearOperator:
    """Coerce an operator-like object: LinearOperator, sparse matrix
    (anything with ``.matvec``), or a bare callable."""
    if isinstance(op, LinearOperator):
        return op
    if hasattr(op, "matvec"):
        return LinearOperator(op.matvec)
    if callable(op):
        return LinearOperator(op)
    raise TypeError(f"cannot interpret {type(op)!r} as an operator")
