"""Segment reductions (counterpart of ``stormx/ops/segment.py``).

The scatter-accumulate primitive of FVM: per-face contributions into cells
(``Feathers/ConvectionScheme.hpp:155-174``, ``Playground.cpp:116-131``).
The port's hot formats (ELL SpMV, cell←face incidence tables) avoid
scatter; these stay the reference path for oracles and one-off assembly.

Segment ids outside ``[0, num_segments)`` are dropped, and an empty segment
gets ``jax.ops.segment_*``'s value: 0 for a sum, +inf/−inf (floats) or the
dtype's max/min (integers) for a min/max.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_min", "segment_max"]


def _valid(data, segment_ids, num_segments: int):
    data = torch.as_tensor(data)
    ids = torch.as_tensor(segment_ids, device=data.device).long()
    keep = (ids >= 0) & (ids < num_segments)
    if not bool(keep.all()):
        data, ids = data[keep], ids[keep]
    return data, ids


def segment_sum(data, segment_ids, num_segments: int):
    """Deterministic Σ over segments: the same bits on every run.

    Floating-point data is sorted stably by segment and reduced segment by
    segment in input order (``torch.segment_reduce``), so the sum does not
    go through the atomics of ``index_add_`` on the card, whose order (and
    so float rounding) varies from run to run.  Integer sums are exact in
    any order and take ``index_add_``.
    """
    data, ids = _valid(data, segment_ids, num_segments)
    shape = (num_segments,) + tuple(data.shape[1:])
    if not (data.is_floating_point() or data.is_complex()):
        return torch.zeros(shape, dtype=data.dtype, device=data.device).index_add_(0, ids, data)
    order = torch.argsort(ids, stable=True)
    lengths = torch.bincount(ids, minlength=num_segments)
    grouped = data[order]
    if data.is_complex():
        out = torch.segment_reduce(torch.view_as_real(grouped), "sum", lengths=lengths, axis=0)
        return torch.view_as_complex(out.contiguous())
    return torch.segment_reduce(grouped, "sum", lengths=lengths, axis=0).reshape(shape)


def _segment_extreme(data, segment_ids, num_segments: int, reduce: str):
    data, ids = _valid(data, segment_ids, num_segments)
    if data.is_floating_point():
        fill = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.max if reduce == "amin" else info.min
    out = torch.full((num_segments,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                     device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    # include_self=False leaves an empty segment's fill value in place.
    return out.scatter_reduce_(0, index, data, reduce, include_self=False)


def segment_min(data, segment_ids, num_segments: int):
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def segment_max(data, segment_ids, num_segments: int):
    return _segment_extreme(data, segment_ids, num_segments, "amax")
