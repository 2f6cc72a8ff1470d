"""Host set-up of the operator (``sparse/windowed.auto_operator``: the
ordering, the SlicedELL build and its upload): host seconds of the
program's ``operator.build`` span."""

from portbench.program_spans import setup_seconds


def read(run):
    return setup_seconds(run, "operator.build")
