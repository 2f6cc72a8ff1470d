"""Chebyshev polynomial preconditioner (counterpart of
``stormx/precond/chebyshev.py``).

    P ≈ A⁻¹  as the degree-k Chebyshev polynomial minimizing
    ‖1 − λ·p(λ)‖ over λ ∈ [λ_min, λ_max].

It needs only operator products: on the card, with ``auto_operator``'s
SlicedELL, every one of them is kernel K1.  ``build`` estimates λ_max by
``power_iters`` power-iteration products from the deterministic
``cos(arange(n))`` start and takes λ_min = λ_max/ratio; ``__call__`` runs the
three-term recurrence, ``degree`` products.  λ_max stays a tensor on the
operator's device, so neither the build nor an apply reads the card.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import vector as v
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import Preconditioner

__all__ = ["ChebyshevPreconditioner"]


class ChebyshevPreconditioner(Preconditioner):
    """Degree-``degree`` Chebyshev approximation of A⁻¹ on [λmax/ratio, λmax].

    ``lambda_max=None`` triggers the power-iteration estimate in ``build``
    (``power_iters`` products, 1.05× safety factor).  ``axis_name`` is kept
    for the distributed slice (only ``None`` is accepted until then).
    """

    def __init__(self, degree: int = 4, *, lambda_max: float | None = None,
                 ratio: float = 30.0, power_iters: int = 10, axis_name: str | None = None):
        self.degree = degree
        self.ratio = ratio
        self.power_iters = power_iters
        self.axis_name = axis_name
        self._lmax = lambda_max
        self._op = None

    def build(self, x, b, op):
        self._op = as_operator(op)
        if self._lmax is None:
            # Power iteration from a deterministic vector (all-ones is a bad
            # seed for symmetric stencils, so perturb it reproducibly).
            seed = torch.cos(torch.arange(b.numel(), dtype=b.dtype, device=b.device))
            seed = seed.reshape(b.shape)
            w = v.scale(1.0 / v.norm_2(seed, axis_name=self.axis_name), seed)
            lmax = torch.zeros((), dtype=b.dtype, device=b.device)
            for _ in range(self.power_iters):
                aw = self._op(w)
                lmax = v.norm_2(aw, axis_name=self.axis_name)
                w = v.scale(1.0 / lmax, aw)
            self._lmax = 1.05 * lmax
        return self

    def __call__(self, r):
        """Three-term Chebyshev recurrence for z ≈ A⁻¹ r."""
        lmax = self._lmax
        lmin = lmax / self.ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma

        z = v.scale(1.0 / theta, r)  # degree-0 term
        if self.degree == 0:
            return z
        d = v.scale(1.0 / theta, r)
        for _ in range(self.degree):
            rho_new = 1.0 / (2.0 * sigma - rho)
            adz = self._op(z)
            resid = v.sub(r, adz)
            d = v.axpy(rho_new * rho, d, v.scale(2.0 * rho_new / delta, resid))
            z = v.add(z, d)
            rho = rho_new
        return z

    def conj_apply(self, r):
        # The polynomial in A is symmetric for symmetric A.
        return self(r)
