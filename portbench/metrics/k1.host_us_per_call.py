"""K1 (``ops/sell_spmv.py``): host microseconds of a call of its wrapper,
``sell_spmv_cuda`` from entry to return (the program's ``k1.launch``
spans), the mean over the traced window."""

from portbench.program_spans import mean_us


def read(run):
    return mean_us(run, "k1.launch")
