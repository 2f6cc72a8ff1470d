from stormx_torch.ops.math import safe_divide, safe_inverse, sign, sym_ortho
from stormx_torch.ops import vector
from stormx_torch.ops.dense import AABB, aabb_of, cross_product, inverse_lu, solve_lu
from stormx_torch.ops.permutations import (
    invert_permutation,
    inverse_permute,
    is_permutation,
    permute,
)
from stormx_torch.ops.segment import segment_max, segment_min, segment_sum

__all__ = [
    "safe_divide",
    "safe_inverse",
    "sign",
    "sym_ortho",
    "vector",
    "segment_sum",
    "is_permutation",
    "invert_permutation",
    "permute",
    "inverse_permute",
    "segment_min",
    "segment_max",
    "AABB",
    "aabb_of",
    "cross_product",
    "solve_lu",
    "inverse_lu",
]
