"""Jacobi (diagonal) and block-Jacobi preconditioners (counterpart of
``stormx/precond/jacobi.py``).

P = diag(𝓐)⁻¹ (Jacobi) or the blockwise inverse of the b×b diagonal blocks
(block-Jacobi).  Zero diagonal entries invert to 0 via ``safe_inverse``.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_inverse
from stormx_torch.solvers.preconditioner import Preconditioner

__all__ = ["JacobiPreconditioner", "BlockJacobiPreconditioner"]


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

    def conj_apply(self, x):
        return x * self._inv_diag.conj().reshape(x.shape)


class BlockJacobiPreconditioner(Preconditioner):
    """Blockwise-diagonal inverse: P·x = D_b⁻¹·x with b×b diagonal blocks.

    Accepts explicit blocks (n_brows, b, b) or a BSR matrix via
    ``.diagonal_blocks()``.  The JAX package solves the blocks at every
    apply (batched ``jnp.linalg.solve``); the port LU-factors them once,
    with partial pivoting as that solve does, and applies the batched
    triangular solves.  The blocks stay on their own device and dtype.
    """

    def __init__(self, blocks=None, matrix=None):
        if blocks is None and matrix is not None:
            blocks = matrix.diagonal_blocks()
        self._lu = None if blocks is None else torch.linalg.lu_factor(blocks)

    def build(self, x, b, op):
        if self._lu is None:
            matrix = getattr(op, "matrix", None)
            if matrix is None or not hasattr(matrix, "diagonal_blocks"):
                raise ValueError(
                    "BlockJacobiPreconditioner needs blocks= or a BSR-backed operator"
                )
            self._lu = torch.linalg.lu_factor(matrix.diagonal_blocks())
        return self

    def __call__(self, x):
        lu, pivots = self._lu
        bsize = lu.shape[-1]
        y = torch.linalg.lu_solve(lu, pivots, x.reshape(-1, bsize, 1))
        return y.reshape(x.shape)
