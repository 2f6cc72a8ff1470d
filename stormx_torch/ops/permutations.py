"""Permutation algorithms (counterpart of ``stormx/ops/permutations.py``;
reference ``Utils/Permutations.hpp``): ``is_permutation`` (whose reference
implementation aborts for n > 2, ``:56-65`` — completed here),
``invert_permutation`` (``:72-104``), and the functional forms of the
in-place cycle-walking ``permute_inplace`` (``:108-148``) as one gather or
one scatter.
"""

from __future__ import annotations

import torch

__all__ = ["is_permutation", "invert_permutation", "permute", "inverse_permute"]


def is_permutation(perm) -> torch.Tensor:
    """True iff ``perm`` is a permutation of 0..n−1 (a bool tensor on
    ``perm``'s device).  Scatter-count check: every slot hit exactly once."""
    perm = torch.as_tensor(perm)
    n = perm.shape[0]
    counts = torch.zeros(n + 1, dtype=torch.int32, device=perm.device)
    counts.index_add_(0, torch.clamp(perm, 0, n).long(),
                      torch.ones(n, dtype=torch.int32, device=perm.device))
    in_range = ((perm >= 0) & (perm < n)).all()
    return in_range & (counts[:n] == 1).all()


def invert_permutation(perm) -> torch.Tensor:
    """iperm with iperm[perm[i]] = i (one scatter)."""
    perm = torch.as_tensor(perm)
    n = perm.shape[0]
    out = torch.zeros(n, dtype=perm.dtype, device=perm.device)
    out[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return out


def permute(values, perm):
    """out[i] = values[perm[i]]."""
    values = torch.as_tensor(values)
    return values[torch.as_tensor(perm, device=values.device).long()]


def inverse_permute(values, perm):
    """out[perm[i]] = values[i] (≡ permute(values, invert_permutation(perm))
    without materializing the inverse)."""
    values = torch.as_tensor(values)
    out = torch.zeros_like(values)
    out[torch.as_tensor(perm, device=values.device).long()] = values
    return out
