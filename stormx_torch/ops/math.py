"""Scalar numerics helpers (counterpart of ``stormx/ops/math.py``).

``safe_divide`` (reference ``Crow/MathUtils.hpp:49-52``) returns 0 when the
denominator is exactly 0; every Krylov recurrence uses it as the breakdown
guard, so its semantics are preserved exactly.
"""

from __future__ import annotations

import torch

__all__ = ["safe_divide", "safe_inverse"]


def safe_divide(x, y):
    """``x / y`` if ``y != 0`` else ``0`` — elementwise, NaN-free."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    zero = y == 0
    q = x / torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(q), q)


def safe_inverse(y):
    """``1 / y`` if ``y != 0`` else ``0`` (reference ``:55-58``)."""
    y = torch.as_tensor(y)
    return safe_divide(torch.ones_like(y), y)
