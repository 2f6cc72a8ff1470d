"""Host dispatch of the eager solver loop: microseconds a Krylov iteration
in which the card idled while the host was inside an iteration's dispatch
(``solver.iterate`` and the spans nested in it), in the cells timed by
``solve_ms``."""

from portbench.program_spans import idle_us_per_iter


def read(run):
    return idle_us_per_iter(run, "dispatch")
