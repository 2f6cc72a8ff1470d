"""Exception hierarchy (counterpart of ``stormx/core/exceptions.py``)."""

from __future__ import annotations

__all__ = ["StormError", "StormIoError"]


class StormError(Exception):
    """Base framework error (reference ``Storm::Error``)."""


class StormIoError(StormError):
    """Mesh/file IO error (reference ``Storm::IoError``)."""
