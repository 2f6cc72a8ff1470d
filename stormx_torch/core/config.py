"""Dtype and device policy.

Counterpart of ``stormx/core/config.py``.  The working precision is float32,
as on the TPU; :func:`enable_x64` makes it float64 (the reference's
``real_t = double``).  That is a flag of this package, read by
:func:`default_real_dtype`: it does not call ``torch.set_default_dtype``,
because the port passes dtypes explicitly and a global torch default would
change every tensor factory of the caller's program.  Entry points take a
``device`` that defaults to ``"cuda"`` and never drift to the CPU silently:
:func:`resolve_device` raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import torch

from stormx_torch.core.exceptions import StormError

__all__ = [
    "enable_x64",
    "x64_enabled",
    "default_real_dtype",
    "default_int_dtype",
    "machine_epsilon",
    "resolve_device",
]

_x64 = False


def enable_x64(enable: bool = True) -> None:
    """Make float64 the working real dtype of this package."""
    global _x64
    _x64 = bool(enable)


def x64_enabled() -> bool:
    return _x64


def default_real_dtype() -> torch.dtype:
    """Working real dtype: float64 when x64 is enabled, else float32."""
    return torch.float64 if _x64 else torch.float32


def default_int_dtype() -> torch.dtype:
    """Index dtype for connectivity tables (CSR/ELL columns): int32."""
    return torch.int32


def machine_epsilon(dtype=None) -> float:
    return float(torch.finfo(dtype or default_real_dtype()).eps)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise StormError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
