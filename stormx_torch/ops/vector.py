"""Vector-space operations on tensors (counterpart of ``stormx/ops/vector.py``).

The JAX package works on pytrees of arrays; every vector of the port is one
tensor.  Reductions keep the ``axis_name`` argument of the JAX signatures,
but only ``None`` is accepted until the distributed slice replaces the
``psum`` with ``torch.distributed.all_reduce``.
"""

from __future__ import annotations

import torch

__all__ = [
    "dot",
    "norm_1",
    "norm_2",
    "norm_inf",
    "norm_p",
    "add",
    "sub",
    "scale",
    "axpy",
    "xpay",
    "fill",
    "zeros_like",
    "copy",
    "lincomb",
    "stacked_zeros",
    "get_stacked",
    "set_stacked",
    "dots_stacked",
    "lincomb_stacked",
    "roll_stacked",
    "tree_where",
]


def _local(axis_name):
    if axis_name is not None:
        raise NotImplementedError("axis_name reductions need the distributed slice")


def dot(x: torch.Tensor, y: torch.Tensor, axis_name=None) -> torch.Tensor:
    """<x ⋅ y> = Σ xᵢ·conj(yᵢ) (reference ``Crow/MathUtils.hpp:93-99``)."""
    _local(axis_name)
    return torch.vdot(y.reshape(-1), x.reshape(-1))  # vdot conjugates its first argument


def norm_2(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Euclidean norm ‖x‖₂ (``Bittern/MatrixAlgorithms.hpp:264-270``)."""
    return torch.sqrt(torch.real(dot(x, x, axis_name=axis_name)))


def norm_1(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    _local(axis_name)
    return torch.sum(torch.abs(x))


def norm_inf(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    _local(axis_name)
    return torch.max(torch.abs(x))


def norm_p(x: torch.Tensor, p, axis_name=None) -> torch.Tensor:
    _local(axis_name)
    return torch.sum(torch.abs(x) ** p) ** (1.0 / p)


def add(x, y):
    return x + y


def sub(x, y):
    return x - y


def scale(a, x):
    return a * x


def axpy(a, x, y):
    """a·x + y."""
    return a * x + y


def xpay(x, a, y):
    """x + a·y."""
    return x + a * y


def fill(x, value):
    return torch.full_like(x, value)


def zeros_like(x):
    return torch.zeros_like(x)


def copy(x):
    return x.clone()


def lincomb(coeffs, vecs):
    """Σᵢ coeffs[i]·vecs[i]."""
    out = scale(coeffs[0], vecs[0])
    for c, v in zip(coeffs[1:], vecs[1:], strict=True):
        out = axpy(c, v, out)
    return out


# ---------------------------------------------------------------------------
# Stacked Krylov bases.
#
# GMRES, IDR(s) and BiCGStab(l) hold small sets of vectors (q₀..q_m, the
# shadow space, ...).  A set of m vectors of length n is one (m, n) tensor,
# so "dot with every basis vector" and "combine basis vectors" are one
# matrix-vector product each.  The solvers index it with host integers.
# ---------------------------------------------------------------------------


def stacked_zeros(template: torch.Tensor, m: int) -> torch.Tensor:
    """A stack of m zero vectors shaped like ``template``."""
    return torch.zeros((m,) + tuple(template.shape), dtype=template.dtype,
                       device=template.device)


def get_stacked(stacked: torch.Tensor, k: int) -> torch.Tensor:
    """stacked[k] (a view: a later :func:`set_stacked` of slot k shows in it)."""
    return stacked[k]


def set_stacked(stacked: torch.Tensor, k: int, vec: torch.Tensor) -> torch.Tensor:
    """stacked[k] = vec, written in place (the JAX package returns a new
    stack; copying an (m, n) basis per update would cost m vectors of
    traffic).  Returns ``stacked``."""
    stacked[k] = vec
    return stacked


def dots_stacked(stacked: torch.Tensor, vec: torch.Tensor, axis_name=None) -> torch.Tensor:
    """[<vec ⋅ stackedᵢ>]ᵢ, all basis dot products in one matrix-vector
    product; <a⋅b> = Σ a·conj(b) as in :func:`dot`."""
    _local(axis_name)
    m = stacked.shape[0]
    return torch.conj(stacked.reshape(m, -1)) @ vec.reshape(-1)


def lincomb_stacked(coeffs: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """Σᵢ coeffs[i]·stacked[i], one (m,)·(m, n) product."""
    return torch.tensordot(coeffs, stacked, dims=1)


def roll_stacked(stacked: torch.Tensor, shift: int) -> torch.Tensor:
    """Circularly shift the stack axis (slot 0 ← slot m−1 for shift=1)."""
    return torch.roll(stacked, shift, dims=0)


def tree_where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select ``a`` or ``b`` on a 0-d boolean tensor, on the device (no host
    sync)."""
    return torch.where(pred, a, b)
