"""Scalar numerics helpers (counterpart of ``stormx/ops/math.py``).

``safe_divide`` (reference ``Crow/MathUtils.hpp:49-52``) returns 0 when the
denominator is exactly 0; every Krylov recurrence uses it as the breakdown
guard, so its semantics are preserved exactly.  ``sym_ortho``
(``:164-179``) is the Givens rotation of GMRES and TFQMR, with a complex
branch for the unitary rotation of complex operators.
"""

from __future__ import annotations

import torch

__all__ = ["safe_divide", "safe_inverse", "sym_ortho", "sign"]


def safe_divide(x, y):
    """``x / y`` if ``y != 0`` else ``0`` — elementwise, NaN-free.  A
    number ``x`` stays a number, so dividing it by a tensor on the card
    copies nothing to the card."""
    y = torch.as_tensor(y, device=x.device if isinstance(x, torch.Tensor) else None)
    zero = y == 0
    q = x / torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(q), q)


def safe_inverse(y):
    """``1 / y`` if ``y != 0`` else ``0`` (reference ``:55-58``)."""
    y = torch.as_tensor(y)
    return safe_divide(torch.ones_like(y), y)


def sym_ortho(a, b):
    """Givens rotation ``(cs, sn, rr)``.

    Real: ``rr = hypot(a, b)``; if ``rr > 0`` then ``cs = a/rr, sn = b/rr``,
    else ``cs = 1, sn = 0``.  Complex: ``rr = hypot(|a|, |b|)`` is real and
    ``cs``, ``sn`` carry the complex dtype; the unitary rotation is then
    ``[[conj(cs), conj(sn)], [-sn, cs]]`` (consumers conjugate the first
    row; ``torch.conj`` is the identity on real tensors, so the real path is
    bit-unchanged).  ``torch.hypot`` has no complex overload, hence the
    moduli.
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    if a.is_complex() or b.is_complex():
        rr = torch.hypot(torch.abs(a), torch.abs(b))  # real
        pos = rr > 0
        rr_safe = torch.where(pos, rr, torch.ones_like(rr))
        one = torch.ones((), dtype=torch.promote_types(a.dtype, b.dtype), device=a.device)
        cs = torch.where(pos, a / rr_safe, one)
        sn = torch.where(pos, b / rr_safe, torch.zeros_like(one))
        return cs, sn, rr
    rr = torch.hypot(a, b)
    pos = rr > 0
    rr_safe = torch.where(pos, rr, torch.ones_like(rr))
    cs = torch.where(pos, a / rr_safe, torch.ones_like(rr))
    sn = torch.where(pos, b / rr_safe, torch.zeros_like(rr))
    return cs, sn, rr


def sign(x):
    """Sign in {-1, 0, +1} (reference ``:107-111``)."""
    return torch.sign(torch.as_tensor(x))
