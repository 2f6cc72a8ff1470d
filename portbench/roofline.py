"""A kernel's calls in the trace, and its share of its roofline.

The least time a call can take is its bytes (``kernels/<id>.py``, from the
shapes the benchmark knows: each stored entry once, each vector once) over
the card's peak bandwidth (``peaks.json``).  The share is that bound over
the kernel's device time per call, taken over its calls inside the span
its shape describes.
"""

from __future__ import annotations

import re


def calls(run, kid: str, span: str | None = None) -> tuple[int, float]:
    """(calls, device seconds) of kernel ``kid`` in the traced window, only
    those launched inside ``span`` when it is given."""
    pattern = re.compile(run.kernels[kid].PATTERN)
    hit = [op for op in run.trace.ops
           if pattern.search(op.name) and (span is None or op.span == span)]
    return len(hit), sum(op.seconds for op in hit)


def share(run, kid: str) -> float | None:
    """Percent of the roofline that kernel ``kid`` reaches; None where the
    run has no trace, no peak for its card, no shape or no call of it."""
    if run.trace is None or not run.peaks or kid not in run.info or kid not in run.kernels:
        return None
    mod = run.kernels[kid]
    n, seconds = calls(run, kid, mod.SPAN)
    if n == 0 or seconds <= 0:
        return None
    bound = n * mod.bytes_per_call(run.info[kid]) / run.peaks["bytes_per_s"]
    return 100.0 * bound / seconds
