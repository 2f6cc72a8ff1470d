"""Plain conjugate gradients with a Jacobi preconditioner, in any dtype.

The control of every cell solves with this: the reference put in the
program's place, to the cell's own tolerance, one precision below the
configuration's.  Plain PyTorch;
nothing of the program.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

CHECK_EVERY = 10  # iterations between the host's reads of the residual


class Solve(NamedTuple):
    x: torch.Tensor
    iterations: int
    converged: bool


def cg(apply: Callable, b: torch.Tensor, x0: torch.Tensor, inv_diag: torch.Tensor, *,
       max_iterations: int, rtol: float = 0.0, atol: float = 0.0) -> Solve:
    """Solve A·x = b from ``x0`` until ‖r‖ ≤ max(rtol·‖r₀‖, atol), the
    program's rule, all in the dtype of ``b``.  ``apply`` computes A·x;
    ``inv_diag`` is 1/diag(A)."""
    x = x0.clone()
    r = b - apply(x)
    goal = max(rtol * float(torch.linalg.vector_norm(r.float())), atol)
    if float(torch.linalg.vector_norm(r.float())) <= goal:
        return Solve(x, 0, True)
    z = inv_diag * r
    p = z
    gamma = torch.dot(r, z)
    for it in range(1, max_iterations + 1):
        q = apply(p)
        alpha = gamma / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = inv_diag * r
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        if it % CHECK_EVERY == 0 or it == max_iterations:
            res = float(torch.linalg.vector_norm(r.float()))
            if res <= goal:
                return Solve(x, it, True)
            if res != res:  # NaN: broken down
                return Solve(x, it, False)
    return Solve(x, max_iterations, False)
