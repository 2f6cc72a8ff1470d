"""Logging shim (counterpart of ``stormx/core/logging.py``): the reference's
spdlog macros (``Crow/Base/Log.hpp:29-54``) map onto Python's stdlib
logging with the same severity ladder (TRACE/DEBUG/INFO/WARNING/ERROR/
CRITICAL).  The root logger is ``stormx_torch``, so the two packages never
share handlers."""

from __future__ import annotations

import logging

__all__ = ["get_logger", "TRACE"]

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_logger = logging.getLogger("stormx_torch")


def get_logger(name: str | None = None) -> logging.Logger:
    return _logger.getChild(name) if name else _logger
