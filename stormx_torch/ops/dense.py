"""Small dense helpers (counterpart of ``stormx/ops/dense.py``).

* ``AABB`` — axis-aligned bounding box with ``extend``
  (``Bittern/AABB.hpp:32-69``), used for mesh extents.
* ``cross_product`` — 2-D (scalar z) and 3-D variants
  (``Bittern/MatrixProduct.hpp:90-138``).
* LU solve/inverse for small dense systems (legacy
  ``Solvers/MatrixDense.hpp:43-234``) — thin wrappers over
  ``torch.linalg.lu_factor``/``lu_solve`` keeping the reference's call
  names (the JAX package wraps ``jax.scipy.linalg``; no kernel of its own).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AABB", "aabb_of", "cross_product", "solve_lu", "inverse_lu"]


@dataclass(frozen=True)
class AABB:
    """Axis-aligned bounding box (reference ``Bittern/AABB.hpp:32-69``)."""

    min: torch.Tensor
    max: torch.Tensor

    def extend(self, point_or_box) -> "AABB":
        if isinstance(point_or_box, AABB):
            other_min, other_max = point_or_box.min, point_or_box.max
        else:
            other_min = other_max = torch.as_tensor(point_or_box, device=self.min.device)
        return AABB(min=torch.minimum(self.min, other_min),
                    max=torch.maximum(self.max, other_max))

    @property
    def center(self) -> torch.Tensor:
        return 0.5 * (self.min + self.max)

    @property
    def extents(self) -> torch.Tensor:
        return self.max - self.min


def aabb_of(points) -> AABB:
    """Bounding box of an (n, dim) point set (one min/max reduction each)."""
    points = torch.as_tensor(points)
    return AABB(min=points.amin(dim=0), max=points.amax(dim=0))


def cross_product(a, b):
    """Cross product: 3-D → vector; 2-D → scalar z-component.

    Reference ``CrossProductView`` (``Bittern/MatrixProduct.hpp:90-138``).
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    if a.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return torch.linalg.cross(a, b)


def solve_lu(a, b):
    """x = a⁻¹·b via LU (reference ``inplace_solve_lu``); ``b`` is (n,) or
    (n, k)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    lu, piv = torch.linalg.lu_factor(a)
    if b.dim() == a.dim() - 1:
        return torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]
    return torch.linalg.lu_solve(lu, piv, b)


def inverse_lu(a):
    """a⁻¹ via LU (reference ``inplace_inverse_lu``)."""
    a = torch.as_tensor(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return solve_lu(a, eye.expand(a.shape))
