"""Laplace2D 9-point Jacobi benchmark, the reference's golden-error anchor
(counterpart of ``stormx/apps/laplace2d.py``; reference
``tests/benchmark/BitternLaplace2D.cpp:44-80``).

N×N grid, ``u[:,0] = sin(x)``, ``u[:,N-1] = sin(x)·e^{-π}`` with ``x =
linspace(0,π,N)``, then ``NumIterations`` Jacobi sweeps of the 9-point
stencil

    u_int ← (4·(N+S+W+E) + (NW+NE+SW+SE)) / 20

with ``error = ‖u − u_old‖_F`` after the final sweep.  Golden values
(``BitternLaplace2D.cpp:403-422``, double, 1000 iterations, tol 1e-4):
N=100 → 0.0069143, N=150 → 0.00994008, N=200 → 0.0121789.

The stencil is static slices (no gather; the JAX module has no Pallas
kernel).  The sweep loop is a Python loop that reads nothing back from the
device; each sweep writes a new tensor and leaves the previous one as it
was, as the JAX sweep does.
"""

from __future__ import annotations

import math

import torch

from stormx_torch.core.config import resolve_device

__all__ = ["laplace2d", "laplace2d_error"]


def _initial(n: int, dtype, device) -> torch.Tensor:
    x = torch.linspace(0.0, math.pi, n, dtype=dtype, device=device)
    u = torch.zeros((n, n), dtype=dtype, device=device)
    u[:, 0] = torch.sin(x)
    u[:, n - 1] = torch.sin(x) * torch.exp(torch.tensor(-math.pi, dtype=dtype, device=device))
    return u


def _sweep(u: torch.Tensor) -> torch.Tensor:
    """One 9-point Jacobi sweep into a new tensor."""
    edge = u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
    corner = u[:-2, :-2] + u[:-2, 2:] + u[2:, :-2] + u[2:, 2:]
    u_new = u.clone()
    u_new[1:-1, 1:-1] = (4.0 * edge + corner) / 20.0
    return u_new


def laplace2d(n: int, num_iterations: int = 1000, dtype=torch.float64, *, device="cuda"):
    """Run the benchmark on ``device``; returns (final u, final-sweep error
    as a 0-d tensor).  The error is computed once, after the last sweep, as
    the JAX loop's carried error of the last sweep is."""
    dev = resolve_device(device)
    u = _initial(n, dtype, dev)
    err = torch.zeros((), dtype=dtype, device=dev)
    for k in range(num_iterations):
        u_new = _sweep(u)
        if k == num_iterations - 1:
            err = torch.linalg.vector_norm(u_new - u)
        u = u_new
    return u, err


def laplace2d_error(n: int, num_iterations: int = 1000, dtype=torch.float64, *,
                    device="cuda") -> float:
    return float(laplace2d(n, num_iterations, dtype, device=device)[1])
