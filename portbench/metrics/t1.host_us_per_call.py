"""T1 (``ops/tri_solve.py``): host microseconds of a call of its wrapper,
``exact_cuda`` from entry to return (the program's ``t1.launch`` spans),
the mean over the traced window."""

from portbench.program_spans import mean_us


def read(run):
    return mean_us(run, "t1.launch")
