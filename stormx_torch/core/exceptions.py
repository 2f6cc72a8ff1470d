"""Exception hierarchy (counterpart of ``stormx/core/exceptions.py``)."""

from __future__ import annotations

__all__ = ["StormError", "StormIoError", "SolverBreakdownError"]


class StormError(Exception):
    """Base framework error (reference ``Storm::Error``)."""


class StormIoError(StormError):
    """Mesh/file IO error (reference ``Storm::IoError``)."""


class SolverBreakdownError(StormError):
    """Numerical breakdown in a Krylov recurrence.

    The reference never raises on breakdown: every division in a solver
    recurrence goes through ``safe_divide`` (``Crow/MathUtils.hpp:49-52``),
    which returns 0.  The solvers keep those semantics; this exception is
    for host-side validation paths.
    """
