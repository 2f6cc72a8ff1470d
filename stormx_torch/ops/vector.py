"""Vector-space operations on tensors (counterpart of ``stormx/ops/vector.py``).

The JAX package works on pytrees of arrays; every vector of the port is one
tensor.  Reductions keep the ``axis_name`` argument of the JAX signatures:
``None`` reduces this tensor alone, and a rank's handle from
:func:`stormx_torch.parallel.make_device_mesh` adds the local result over
the ranks with one ``all_reduce`` (the JAX package's ``lax.psum``; a max
for ``norm_inf``).
"""

from __future__ import annotations

import torch

from stormx_torch.core.exceptions import StormError

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


def _mesh(axis_name):
    if not hasattr(axis_name, "all_reduce_sum"):
        raise StormError(
            f"axis_name={axis_name!r}: pass the rank's handle from "
            "stormx_torch.parallel.make_device_mesh"
        )
    return axis_name


def _psum(local: torch.Tensor, axis_name) -> torch.Tensor:
    """Σ of ``local`` over the ranks of ``axis_name`` (itself for None)."""
    if axis_name is None:
        return local
    return _mesh(axis_name).all_reduce_sum(local)


def dot(x: torch.Tensor, y: torch.Tensor, axis_name=None) -> torch.Tensor:
    """<x ⋅ y> = Σ xᵢ·conj(yᵢ) (reference ``Crow/MathUtils.hpp:93-99``)."""
    # vdot conjugates its first argument.
    return _psum(torch.vdot(y.reshape(-1), x.reshape(-1)), axis_name)


def norm_2(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Euclidean norm ‖x‖₂ (``Bittern/MatrixAlgorithms.hpp:264-270``)."""
    return torch.sqrt(torch.real(dot(x, x, axis_name=axis_name)))


def norm_1(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    return _psum(torch.sum(torch.abs(x)), axis_name)


def norm_inf(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    local = torch.max(torch.abs(x))
    return local if axis_name is None else _mesh(axis_name).all_reduce_max(local)


def norm_p(x: torch.Tensor, p, axis_name=None) -> torch.Tensor:
    return _psum(torch.sum(torch.abs(x) ** p), axis_name) ** (1.0 / p)


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
    m = stacked.shape[0]
    return _psum(torch.conj(stacked.reshape(m, -1)) @ vec.reshape(-1), axis_name)


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
