"""Readers shared by the per-layer metrics that each cell reports under its
own name (``<metric>.step`` in the cells timed by ``step_ms``,
``<metric>.solve`` in those timed by ``solve_ms``)."""


def iterations(run):
    """Krylov solver loop (``solvers/cg.py``, ``solvers/base.py``): iterations
    to the cell's tolerance, the mean over the window's solves, as
    ``SolveResult.num_iterations`` counts them."""
    if not run.records:
        return None
    return run.iterations / len(run.records)


def launches_per_iter(run):
    """Host dispatch of the eager solver loop: device operations (kernels,
    memsets, copies) in the traced window per Krylov iteration."""
    if run.trace is None or not run.trace.ops or run.iterations == 0:
        return None
    return len(run.trace.ops) / run.iterations


def algebra_us_per_iter(run):
    """Vector algebra (``ops/vector.py``, ``ops/math.py``: torch elementwise
    and reductions): device microseconds per Krylov iteration of the
    operations the solver loop launches itself, inside a solve but outside the
    operator and the preconditioner."""
    if run.trace is None or run.iterations == 0:
        return None
    ops = [op for op in run.trace.ops if op.span == "solve"]
    if not ops:
        return None
    return 1e6 * sum(op.seconds for op in ops) / run.iterations


def idle_share(run):
    """Device: the share of the traced window in which no operation ran on
    the card, in percent (1 − the union of the operations' intervals over
    the window)."""
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
