"""Dtype and device policy.

Counterpart of ``stormx/core/config.py``.  The working precision on the card
is float32, as on the TPU; callers that need float64 (parity tests, the CPU
reference run) pass ``dtype=torch.float64`` explicitly.  Entry points take a
``device`` that defaults to ``"cuda"`` and never drift to the CPU silently:
:func:`resolve_device` raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import torch

from stormx_torch.core.exceptions import StormError

__all__ = ["default_real_dtype", "resolve_device"]


def default_real_dtype() -> torch.dtype:
    """Working real dtype: float32 (fp64 only where the caller asks)."""
    return torch.float32


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise StormError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
