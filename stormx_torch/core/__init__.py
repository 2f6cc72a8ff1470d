from stormx_torch.core.config import default_real_dtype, resolve_device
from stormx_torch.core.exceptions import StormError, StormIoError

__all__ = ["default_real_dtype", "resolve_device", "StormError", "StormIoError"]
