"""Runtime checking (counterpart of ``stormx/core/debug.py``).

* :func:`enable_nan_checks` — one global dispatch mode that raises
  ``FloatingPointError`` at the first op that produces a NaN from NaN-free
  inputs, as ``jax_debug_nans`` does.
* :func:`checked` — run a function under a dispatch mode that records the
  first checked error instead of raising, as ``jax.experimental.checkify``
  does: a NaN produced from NaN-free inputs, an integer division by zero,
  or an out-of-range index (``index``, ``index_select``, ``gather``,
  ``take``, ``index_put``).  Index bounds are checked BEFORE the op is
  dispatched, because on the card an out-of-range gather trips a
  device-side assert that poisons the CUDA context for the rest of the
  process; the op then runs with its indices clamped into range (the TPU
  gather's behaviour) and an integer division with its zero divisors set to
  1, so the function still returns.
* :func:`assert_deterministic` — run a function twice and demand bit-equal
  outputs.

Both modes read values back to the host after each op (one sync per op and
more): they are debugging tools, not for timed runs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from stormx_torch.core.exceptions import StormError

__all__ = ["enable_nan_checks", "checked", "assert_deterministic", "CheckError"]

ALL_CHECKS = frozenset({"nan", "index", "div"})

# Ops that hand back uninitialised memory: their NaNs were not produced.
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "resize_", "set_"})
# Index ops whose indices wrap like Python's (−n ≤ i < n) and ops that take
# only 0 ≤ i < n.
_WRAPPING = frozenset({"index", "index_put", "index_put_", "_index_put_impl_", "take"})
_NONNEGATIVE = frozenset({"index_select", "gather"})
_INT_DIVISION = frozenset({"div", "div_", "floor_divide", "floor_divide_", "remainder",
                           "remainder_", "fmod", "fmod_"})


class CheckError(StormError):
    """Raised by ``Error.throw`` for an error that :func:`checked` recorded."""


class Error:
    """The first error :func:`checked` recorded (``get`` is None if none)."""

    def __init__(self, msg: str | None = None):
        self._msg = msg

    def get(self) -> str | None:
        return self._msg

    def throw(self) -> None:
        if self._msg is not None:
            raise CheckError(self._msg)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.layout == torch.strided and (
        t.is_floating_point() or t.is_complex())


def _is_int(t) -> bool:
    return (isinstance(t, torch.Tensor) and not t.is_floating_point() and not t.is_complex()
            and t.dtype != torch.bool)


def _has_nan(leaves) -> bool:
    for x in leaves:
        if _is_float(x) and x.numel() and bool(torch.isnan(x).any()):
            return True
        if isinstance(x, (float, complex)) and (x != x):
            return True
    return False


class _CheckMode(TorchDispatchMode):
    """Checks every dispatched op; ``raise_now`` raises at the first error
    (``FloatingPointError`` for a NaN), otherwise the first error is kept."""

    def __init__(self, checks=ALL_CHECKS, *, raise_now: bool = False):
        super().__init__()
        self.checks = frozenset(checks)
        self.raise_now = raise_now
        self.error: str | None = None

    def _record(self, msg: str, exc=CheckError) -> None:
        if self.raise_now:
            raise exc(msg)
        if self.error is None:
            self.error = msg

    def _bounded(self, t: torch.Tensor, n: int, wraps: bool, what: str) -> torch.Tensor:
        if t.dtype == torch.bool or t.dtype == torch.uint8 or t.numel() == 0:
            return t
        lo, hi = (-n if wraps else 0), n - 1
        t_min, t_max = int(t.min()), int(t.max())
        if t_min >= lo and t_max <= hi:
            return t
        bad = t_min if t_min < lo else t_max
        self._record(f"out-of-bounds indexing in {what}: index {bad} is out of bounds "
                     f"for an axis of size {n}")
        return t.clamp(lo, hi) if n > 0 else t

    def _check_indices(self, name: str, func, args):
        args = list(args)
        what = str(func)
        if name in _WRAPPING and name != "take":
            src, indices, d, fixed = args[0], list(args[1]), 0, []
            for idx in indices:
                if idx is None:
                    d += 1
                elif idx.dtype in (torch.bool, torch.uint8):
                    d += idx.dim()
                else:
                    idx = self._bounded(idx, src.shape[d], True, what)
                    d += 1
                fixed.append(idx)
            args[1] = fixed
        elif name == "take":
            args[1] = self._bounded(args[1], args[0].numel(), True, what)
        else:  # index_select / gather: (self, dim, index, ...)
            src, dim = args[0], args[1]
            n = src.shape[dim] if src.dim() else 1
            args[2] = self._bounded(args[2], n, False, what)
        return tuple(args)

    def _check_division(self, func, args, kwargs):
        mode = kwargs.get("rounding_mode", args[2] if len(args) > 2 else None)
        name = func.overloadpacket.__name__
        if name in ("div", "div_") and mode is None:
            return args  # true division: a float result
        num, den = args[0], args[1]
        if not _is_int(num):
            return args
        if _is_int(den):
            if bool((den == 0).any()):
                self._record(f"division by zero in {func}")
                den = torch.where(den == 0, torch.ones_like(den), den)
        elif isinstance(den, int) and not isinstance(den, bool) and den == 0:
            self._record(f"division by zero in {func}")
            den = 1
        return (num, den) + tuple(args[2:])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if "index" in self.checks and (name in _WRAPPING or name in _NONNEGATIVE):
            args = self._check_indices(name, func, args)
        if "div" in self.checks and name in _INT_DIVISION:
            args = self._check_division(func, args, kwargs)
        check_nan = "nan" in self.checks and name not in _UNINITIALISED
        in_leaves = _pytree.tree_leaves((args, kwargs))
        # A mutating op overwrites its inputs: read them before it runs.
        nan_before = check_nan and func._schema.is_mutable and _has_nan(in_leaves)
        out = func(*args, **kwargs)
        if check_nan and (self.raise_now or self.error is None):
            if _has_nan(_pytree.tree_leaves(out)) and not (
                    nan_before or (not func._schema.is_mutable and _has_nan(in_leaves))):
                self._record(f"nan generated by primitive: {func}", FloatingPointError)
        return out


def checked(fn, *, errors=None):
    """Wrap ``fn``: the wrapper returns ``(error, out)``; call
    ``error.throw()``.  ``errors``: the checks to make, any of ``"nan"``,
    ``"index"`` and ``"div"`` (default all)."""
    checks = ALL_CHECKS if errors is None else frozenset(errors)
    if not checks <= ALL_CHECKS:
        raise ValueError(f"unknown checks {sorted(checks - ALL_CHECKS)}")

    def wrapper(*args, **kwargs):
        mode = _CheckMode(checks)
        with mode:
            out = fn(*args, **kwargs)
        return Error(mode.error), out

    return wrapper


_nan_mode: _CheckMode | None = None


def enable_nan_checks(on: bool = True) -> None:
    """Raise ``FloatingPointError`` at the first op that produces a NaN from
    NaN-free inputs (``on=False`` turns it off).  Idempotent: calling it
    twice pushes one mode.  Other dispatch modes entered while it is on must
    be left before it is turned off."""
    global _nan_mode
    if on and _nan_mode is None:
        _nan_mode = _CheckMode({"nan"}, raise_now=True)
        _nan_mode.__enter__()
    elif not on and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)


def _host_leaves(tree) -> list:
    """Leaves of ``tree`` (tensors copied to the host; dataclasses such as
    ``SolveResult`` opened field by field)."""
    out = []
    for leaf in _pytree.tree_leaves(tree):
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out.extend(_host_leaves([getattr(leaf, f.name) for f in dataclasses.fields(leaf)]))
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().cpu())
        else:
            out.append(leaf)
    return out


def _bit_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.dtype != b.dtype or a.shape != b.shape:
            return False
        return torch.equal(a.contiguous().view(torch.uint8) if a.dim() else
                           a.reshape(1).view(torch.uint8),
                           b.contiguous().view(torch.uint8) if b.dim() else
                           b.reshape(1).view(torch.uint8))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def assert_deterministic(fn, *args, runs: int = 2) -> None:
    """Demand bit-identical outputs across repeated executions (compared on
    host copies)."""
    ref = _host_leaves(fn(*args))
    for k in range(runs - 1):
        out = _host_leaves(fn(*args))
        if len(out) != len(ref):
            raise AssertionError(f"run {k + 2} returned {len(out)} leaves, run 1 {len(ref)}")
        for i, (a, b) in enumerate(zip(ref, out)):
            if not _bit_equal(a, b):
                raise AssertionError(f"leaf {i} of run {k + 2} differs from run 1")
