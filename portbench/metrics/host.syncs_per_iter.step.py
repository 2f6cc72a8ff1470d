"""Host dispatch of the eager solver loop: the program's blocking reads of
the device (its ``solver.read`` spans) per Krylov iteration, in the cells
timed by ``step_ms``."""

from portbench.program_spans import READ, per_iteration


def read(run):
    return per_iteration(run, READ)
