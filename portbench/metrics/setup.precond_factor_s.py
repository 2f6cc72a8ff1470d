"""Host set-up of IC(0) (``IcPreconditioner``): host seconds of its host
factorization with the transpose (the program's ``precond.factor`` span),
the host share of ``setup.precond_s``."""

from portbench.program_spans import setup_seconds


def read(run):
    return setup_seconds(run, "precond.factor")
