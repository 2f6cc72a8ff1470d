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
