"""Jacobi (diagonal) preconditioner (counterpart of ``JacobiPreconditioner``
in ``stormx/precond/jacobi.py``).

P·x = x / diag(𝓐); zero diagonal entries invert to 0 via ``safe_inverse``.
"""

from __future__ import annotations

from stormx_torch.ops import safe_inverse
from stormx_torch.solvers.preconditioner import Preconditioner

__all__ = ["JacobiPreconditioner"]


class JacobiPreconditioner(Preconditioner):
    """Construct from an explicit diagonal, or from a matrix exposing
    ``.diagonal()``; ``build`` reads the diagonal from the operator's
    ``matrix`` when neither was given."""

    def __init__(self, diag=None, matrix=None):
        if diag is None and matrix is not None:
            diag = matrix.diagonal()
        self._inv_diag = None if diag is None else safe_inverse(diag)

    def build(self, x, b, op):
        if self._inv_diag is None:
            matrix = getattr(op, "matrix", None)
            if matrix is None or not hasattr(matrix, "diagonal"):
                raise ValueError(
                    "JacobiPreconditioner needs an explicit diag= or a matrix-"
                    "backed operator with .diagonal()"
                )
            self._inv_diag = safe_inverse(matrix.diagonal())
        return self

    def __call__(self, x):
        return x * self._inv_diag.reshape(x.shape)
