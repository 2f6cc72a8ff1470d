"""K1, the port's SlicedELL SpMV (``stormx_torch/ops/sell_spmv.py``,
``csrc/sell_spmv.cu``, both branches): y = A·x for the Krylov solver loop's
operator apply."""

PATTERN = r"sell_spmv(_staged)?_kernel"
SPAN = "operator"  # the calls whose shape ``bytes_per_call`` counts


def bytes_per_call(shape: dict) -> float:
    """Each stored entry once (its value, of ``itemsize`` bytes, float32's 4 unless
    the shape says, and a 4-byte column), x and y once."""
    itemsize = shape.get("itemsize", 4)
    return shape["entries"] * (itemsize + 4) + 2 * itemsize * shape["rows"]
