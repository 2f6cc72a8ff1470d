from stormx_torch.ops.math import safe_divide, safe_inverse, sign, sym_ortho
from stormx_torch.ops import vector

__all__ = ["safe_divide", "safe_inverse", "sign", "sym_ortho", "vector"]
