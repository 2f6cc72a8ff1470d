"""Gather-free block-aggregation AMG for banded (DIA) operators
(counterpart of ``stormx/precond/block_amg.py``).

The aggregates are g consecutive rows of the band-reduced ordering, so
every V-cycle ingredient is a plain vector operation or a DIA matvec:

* restriction  = ``pad(r, nc·g).reshape(nc, g).sum(1)``
* prolongation = ``e_c.repeat_interleave(g)[:n]``
* level matvec = ``DIA.matvec``, kernel K2a on the card
* smoother     = weighted Jacobi (elementwise)

The JAX package computes the two sums as 0/1 matrix products on the TPU's
matrix unit; these are the same sums.  The Galerkin product R·A·P of a
banded A stays banded (fine diagonal ``off`` feeds coarse diagonals
``off//g`` and ``off//g + 1`` only), so the coarse hierarchy is computed on
the host in O(nnz) NumPy per level, and every level is a ``DIA`` on the
fine operator's device.  Symmetric (same pre/post Jacobi sweeps, R = Pᵀ),
hence CG-safe on SPD operators.
"""

from __future__ import annotations

import numpy as np
import torch

from stormx_torch.solvers.preconditioner import Preconditioner
from stormx_torch.sparse.formats import DIA, host

__all__ = ["BlockDiaAmg", "restrict_sum", "prolong_repeat"]

# The JAX package's restriction needs g | 128 (its lane width); the same
# check keeps both packages accepting the same arguments.
_LANES = 128


def restrict_sum(r: torch.Tensor, nc: int, g: int) -> torch.Tensor:
    """Sum groups of ``g`` consecutive entries: (n,) → (nc,)."""
    return torch.nn.functional.pad(r, (0, nc * g - r.shape[0])).reshape(nc, g).sum(1)


def prolong_repeat(e_c: torch.Tensor, n: int, g: int) -> torch.Tensor:
    """Adjoint of :func:`restrict_sum`: repeat each entry ``g`` times,
    (nc,) → (n,)."""
    return e_c.repeat_interleave(g)[:n]


def _coarsen_dia(offsets, data, n, g):
    """Galerkin R·A·P for piecewise-constant aggregation over g consecutive
    rows.  A_c[I, J] = Σ_{i//g == I} Σ_d [ (i+off_d)//g == J ] data[d, i].

    Returns (coarse_offsets, coarse_data, nc) in the same row-aligned DIA
    layout; O(nnz) vectorized (a copy of the JAX package's host code)."""
    nc = -(-n // g)
    i = np.arange(n)
    ci = i // g
    acc: dict[int, np.ndarray] = {}
    for d, off in enumerate(offsets):
        j = i + off
        valid = (j >= 0) & (j < n)
        cj = np.zeros_like(ci)
        cj[valid] = j[valid] // g
        oc = cj - ci
        for o in np.unique(oc[valid]):
            m = valid & (oc == o)
            buf = acc.setdefault(int(o), np.zeros(nc))
            np.add.at(buf, ci[m], data[d, m])
    coarse_offsets = tuple(sorted(acc))
    coarse = np.zeros((len(coarse_offsets), nc))
    for k, o in enumerate(coarse_offsets):
        coarse[k] = acc[o]
        # enforce the row-aligned zero-outside-band convention
        rows = np.arange(nc)
        coarse[k][(rows + o < 0) | (rows + o >= nc)] = 0.0
    return coarse_offsets, coarse, nc


class BlockDiaAmg(Preconditioner):
    """V-cycle AMG over g-row block aggregates of a DIA operator.

    ``dia``: :class:`stormx_torch.sparse.formats.DIA`, already in its banded
    ordering.  ``group``: rows per aggregate (coarsening factor per level).
    ``dtype``: the levels' dtype, by default the operator's.  The set-up is
    host NumPy in float64; the levels live on the operator's device.
    """

    def __init__(self, dia, *, group: int = 4, num_sweeps: int = 1,
                 omega: float = 2.0 / 3.0, coarse_size: int = 256,
                 max_levels: int = 16, dtype: torch.dtype | None = None):
        if group < 2:
            raise ValueError("group must be ≥ 2")
        if _LANES % group:
            raise ValueError(
                f"group must divide {_LANES} (the JAX package's lane-aligned "
                f"restriction); got {group}"
            )
        self.group = g = int(group)
        self.num_sweeps = num_sweeps
        self.omega = omega

        offsets = tuple(int(o) for o in dia.offsets)
        data = host(dia.data).astype(np.float64)
        n = dia.shape[0]
        dtype = dtype or dia.data.dtype
        device = dia.data.device
        if 0 not in offsets:
            raise ValueError("BlockDiaAmg needs an explicitly stored diagonal")

        def tensor(a):
            return torch.as_tensor(a, device=device).to(dtype)

        self._levels = []
        while n > coarse_size and len(self._levels) < max_levels:
            diag0 = data[offsets.index(0)]
            inv_diag = np.where(diag0 != 0.0, 1.0 / np.where(diag0 == 0, 1, diag0), 0.0)
            self._levels.append({
                "op": DIA(data=tensor(data), offsets=offsets, shape=(n, n)),
                "inv_diag": tensor(inv_diag),
                "n": n,
                "nc": -(-n // g),
            })
            offsets, data, n = _coarsen_dia(offsets, data, n, g)

        # Dense coarse factor (pinv: the top level of an SPD hierarchy is
        # SPD up to boundary zero-rows from padding).
        dense = np.zeros((n, n))
        rows = np.arange(n)
        for d, off in enumerate(offsets):
            valid = (rows + off >= 0) & (rows + off < n)
            dense[rows[valid], rows[valid] + off] = data[d, valid]
        self._coarse_inv = tensor(np.linalg.pinv(dense))

    # -- device-side V-cycle (vector operations and DIA matvecs) -----------
    def build(self, x, b, op):
        return self

    def _smooth(self, lvl, x, b, *, from_zero=False):
        sweeps = self.num_sweeps
        if from_zero:
            # The first sweep from x = 0 is ω·D⁻¹·b: no matvec of zeros.
            x = self.omega * lvl["inv_diag"] * b
            sweeps -= 1
        for _ in range(sweeps):
            r = b - lvl["op"].matvec(x)
            x = x + self.omega * lvl["inv_diag"] * r
        return x

    def _vcycle(self, k, b):
        if k == len(self._levels):
            return self._coarse_inv @ b
        lvl = self._levels[k]
        g, n, nc = self.group, lvl["n"], lvl["nc"]
        x = self._smooth(lvl, None, b, from_zero=True)
        r = b - lvl["op"].matvec(x)
        e_c = self._vcycle(k + 1, restrict_sum(r, nc, g))
        x = x + prolong_repeat(e_c, n, g)
        return self._smooth(lvl, x, b)

    def __call__(self, r):
        return self._vcycle(0, r)
