"""T1, the port's exact level-scheduled triangular solve
(``stormx_torch/ops/tri_solve.py``, ``csrc/tri_solve.cu``, branches
"grid" and "block"): one call per factor of a preconditioner apply."""

PATTERN = r"tri_(exact|block)_kernel"
SPAN = "precond"


def bytes_per_call(shape: dict) -> float:
    """Each off-diagonal entry once (value and 4-byte column), the diagonal's
    values, r and y once."""
    itemsize = shape.get("itemsize", 4)
    return shape["entries"] * (itemsize + 4) + 3 * itemsize * shape["rows"]
