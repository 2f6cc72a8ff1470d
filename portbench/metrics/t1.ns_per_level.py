"""T1 (``ops/tri_solve.py``): device nanoseconds per level of the factor's
level schedule, per call.  T1's limiter is the latency of each level, not
its bytes."""

from portbench.roofline import calls


def read(run):
    if run.trace is None or "levels" not in run.info.get("t1", {}):
        return None
    n, seconds = calls(run, "t1")
    if n == 0:
        return None
    return 1e9 * seconds / n / run.info["t1"]["levels"]
