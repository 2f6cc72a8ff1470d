"""Operator abstraction (counterpart of ``stormx/solvers/operator.py``;
reference ``Solvers/Operator.hpp:66-200``): a thin wrapper around a callable
``x ↦ A(x)`` on tensors, with the optional conjugate (adjoint) product
``conj_apply`` that LSQR and LSMR need.
"""

from __future__ import annotations

from typing import Callable

from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import vector as v

__all__ = ["LinearOperator", "make_operator", "make_symmetric_operator", "as_operator"]


class LinearOperator:
    """Matrix-free operator y = A(x).

    ``conj_apply`` is the conjugate (adjoint) product 𝓐*(x); like the
    reference (``Operator.hpp:120-127``), ``conj_mul`` raises when it is
    unset.
    """

    def __init__(self, apply: Callable, conj_apply: Callable | None = None):
        self._apply = apply
        self._conj_apply = conj_apply

    def __call__(self, x):
        return self._apply(x)

    def mul(self, x):
        return self._apply(x)

    def conj_mul(self, x):
        if self._conj_apply is None:
            raise StormError(
                "an operator without the specified conjugate operator"
            )  # the reference's behaviour, Operator.hpp:123-126
        return self._conj_apply(x)

    def residual(self, b, x):
        """r = b − 𝓐(x) (reference ``Operator.hpp:95-99``)."""
        return v.sub(b, self(x))

    def residual_norm(self, b, x, axis_name=None):
        return v.norm_2(self.residual(b, x), axis_name=axis_name)


def make_operator(apply, conj_apply=None) -> LinearOperator:
    """Wrap callables into an operator (reference ``Operator.hpp:174-193``)."""
    return LinearOperator(apply, conj_apply)


def make_symmetric_operator(apply) -> LinearOperator:
    """Self-adjoint operator: 𝓐* = 𝓐 (reference ``Operator.hpp:196-200``)."""
    return LinearOperator(apply, apply)


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
