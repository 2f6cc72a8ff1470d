"""Preconditioner (``precond/factorized.py``):
device milliseconds per apply, the operations launched inside the apply's
span over the applies in the traced window."""


def read(run):
    if run.trace is None:
        return None
    applies = run.trace.count("precond")
    ops = [op for op in run.trace.ops if op.span == "precond"]
    if applies == 0 or not ops:
        return None
    return 1e3 * sum(op.seconds for op in ops) / applies
