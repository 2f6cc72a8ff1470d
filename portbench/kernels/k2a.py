"""K2a, the port's DIA SpMV (``stormx_torch/ops/dia.py``,
``csrc/dia_spmv.cu``): y = A·x for the Krylov solver loop's operator apply
(the values of ``itemsize`` bytes, float32's 4 unless the shape says)."""

PATTERN = r"dia_spmv_kernel"
SPAN = "operator"


def bytes_per_call(shape: dict) -> float:
    """Each non-zero's value once (DIA stores no column), x and y once."""
    itemsize = shape.get("itemsize", 4)
    return shape["entries"] * itemsize + 2 * itemsize * shape["rows"]
