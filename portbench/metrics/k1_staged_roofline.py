"""K1's "staged" branch (``csrc/sell_spmv.cu`` ``sell_spmv_staged_kernel``):
its share of its roofline, in percent, over every staged call in the traced
window (in the CH cells each is the CG operator's; the step's affine
constant runs through K3).  Bytes by ``kernels/k1.py`` from the shape in
``info["k1"]``, as ``roofline.py`` counts them."""

import re

STAGED = re.compile(r"sell_spmv_staged_kernel")


def read(run):
    if run.trace is None or not run.peaks or "k1" not in run.info or "k1" not in run.kernels:
        return None
    hit = [op for op in run.trace.ops if STAGED.search(op.name)]
    seconds = sum(op.seconds for op in hit)
    if not hit or seconds <= 0:
        return None
    bound = len(hit) * run.kernels["k1"].bytes_per_call(run.info["k1"]) / run.peaks["bytes_per_s"]
    return 100.0 * bound / seconds
