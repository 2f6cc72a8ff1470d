"""The five-point Poisson operator in DIA layout (a frozen copy of
``chip_smoke.py:poisson5_diags``, itself ``bench.py``'s)."""

from __future__ import annotations

import numpy as np


def poisson5_diags(nx: int, dtype=np.float32):
    """5-point Laplacian on an nx×nx grid in DIA layout.  Returns
    (offsets, data) with data[d, i] = A[i, i + offsets[d]]."""
    n = nx * nx
    i = np.arange(n) // nx
    j = np.arange(n) % nx
    offsets = (-nx, -1, 0, 1, nx)
    data = np.zeros((5, n), dtype=dtype)
    data[0] = np.where(i > 0, -1.0, 0.0)  # west  neighbor (i-1, j)
    data[1] = np.where(j > 0, -1.0, 0.0)  # south neighbor (i, j-1)
    data[2] = 4.0
    data[3] = np.where(j < nx - 1, -1.0, 0.0)  # north (i, j+1)
    data[4] = np.where(i < nx - 1, -1.0, 0.0)  # east  (i+1, j)
    return offsets, data


def poisson5_nonzeros(nx: int) -> int:
    """Stored non-zeros of the five-point operator: 5 per row, less one
    per row and missing neighbour on each of the four sides."""
    return 5 * nx * nx - 4 * nx
