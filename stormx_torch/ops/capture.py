"""What a CUDA graph capture needs from the kernel wrappers.

* :func:`refuse` — a layer that cannot be replayed from a graph (T1, which
  keeps host state between calls, ``ops/tri_solve.py``; a solve, which
  reads the device; the check modes of ``core/debug.py``) calls it first
  thing at every call.  While the current stream captures it raises
  :class:`stormx_torch.core.exceptions.CaptureRefusedError`, before the
  layer takes any state, so the capture can be ended and the work run
  eagerly instead; otherwise it counts the call in :data:`refusals`, so a
  solve loop that sees the count move over its eager iterations captures
  none of them (``solvers/base.py``).  So the refusal is seen through any
  wrapper, and nothing is remembered between solves.
* The launch counters.  Each wrapper of a hand-written kernel counts its
  launches on the host: module counters (an int, or a dict of ints by
  kernel or branch) and K3's counters on each plan.  A capture launches
  nothing, and a replay runs no wrapper, so the solver loop's graph path
  (``solvers/base.py``) takes back what a capture counted
  (:func:`take_back`) and adds it again at each replay (:func:`add`): the
  counters then count what the card ran.  Counts made by another thread
  while one captures land in that capture's change.
"""

from __future__ import annotations

import types

import torch

from stormx_torch.core.exceptions import CaptureRefusedError

__all__ = ["capturing", "refuse", "refusals", "snapshot", "take_back", "add"]

refusals = 0  # calls of layers that cannot be captured, made outside a capture


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    there is no CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def refuse(why: str) -> None:
    """Raise :class:`CaptureRefusedError` (``why``) while the current
    stream captures; otherwise count the call in :data:`refusals`."""
    global refusals
    if capturing():
        raise CaptureRefusedError(why)
    refusals += 1


def _cells():
    """(holder, key) of every launch counter: a module and the name of its
    int, or a dict and one of its keys."""
    from stormx_torch.ops import banded_gather, dia, sell_packed, sell_spmv, tri_solve

    yield sell_spmv, "launches"
    yield banded_gather, "launches"
    dicts = [sell_spmv.branch_launches, banded_gather.branch_launches, dia.launches,
             sell_packed.launches, tri_solve.launches, tri_solve.slot_launches]
    for plan in banded_gather.live_plans():
        dicts += [plan.launches_by_shape, plan.launches_by_branch]
    for d in dicts:
        for key in list(d):
            yield d, key


def _get(holder, key) -> int:
    return getattr(holder, key) if isinstance(holder, types.ModuleType) else holder[key]


def _set(holder, key, value: int) -> None:
    if isinstance(holder, types.ModuleType):
        setattr(holder, key, value)
    else:
        holder[key] = value


def snapshot() -> dict:
    """Every launch counter's value now."""
    return {(id(h), k): (h, k, _get(h, k)) for h, k in _cells()}


def take_back(before: dict) -> list:
    """Undo every count made since ``before`` (a :func:`snapshot`) and
    return the change as (holder, key, count) for :func:`add`."""
    change = []
    for ident, (h, k, now) in snapshot().items():
        d = now - before.get(ident, (h, k, 0))[2]
        if d:
            _set(h, k, now - d)
            change.append((h, k, d))
    return change


def add(change: list) -> None:
    """Count ``change`` (from :func:`take_back`) once more."""
    for h, k, d in change:
        _set(h, k, _get(h, k) + d)
