from stormx_torch.core.config import (
    default_int_dtype,
    default_real_dtype,
    enable_x64,
    machine_epsilon,
    resolve_device,
    x64_enabled,
)
from stormx_torch.core.exceptions import SolverBreakdownError, StormError, StormIoError
from stormx_torch.core.logging import get_logger
from stormx_torch.core.banner import print_banner
from stormx_torch.core.debug import assert_deterministic, checked, enable_nan_checks
from stormx_torch.core.profiling import annotate, trace

__all__ = [
    "default_int_dtype",
    "default_real_dtype",
    "enable_x64",
    "machine_epsilon",
    "resolve_device",
    "x64_enabled",
    "SolverBreakdownError",
    "StormError",
    "StormIoError",
    "get_logger",
    "print_banner",
    "assert_deterministic",
    "checked",
    "enable_nan_checks",
    "annotate",
    "trace",
]
