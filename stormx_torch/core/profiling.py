"""Tracing / profiling hooks (counterpart of ``stormx/core/profiling.py``).

* ``trace(log_dir)`` — a ``torch.profiler`` session (CPU and, where there
  is one, CUDA activities) that writes a Chrome/TensorBoard trace
  (``*.pt.trace.json``) into ``log_dir``.
* ``annotate(name)`` — a named region that shows up inside the trace
  (``record_function``), and as an NVTX range on the card.
* ``Timer`` — host-side wall-clock section timer with per-section
  accumulation, for solver drivers and IO.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["trace", "annotate", "Timer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable with TensorBoard/Perfetto."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler region (``with annotate("cg-iterate"): ...``)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Timer:
    """Accumulating wall-clock section timer.

    >>> t = Timer()
    >>> with t("spmv"):
    ...     y = op(x); torch.cuda.synchronize()
    >>> t.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, section: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[section] += time.perf_counter() - t0
            self.counts[section] += 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name]*1e3:.2f} ms "
            f"({self.counts[name]}x, {self.totals[name]/self.counts[name]*1e6:.1f} us avg)"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        out = "\n".join(lines)
        print(out)
        return out
