"""Tracing hooks (counterpart of ``stormx/core/profiling.py``).

* ``trace(log_dir)`` — a ``torch.profiler`` session (CPU and, where there
  is one, CUDA activities) that writes a Chrome/TensorBoard trace
  (``*.pt.trace.json``) into ``log_dir``.
* ``annotate(name)`` — the port's span: a named region kept in memory with
  its start and end on the profiler's host clock, its parent and its root
  (:func:`spans` returns them); while a profiler session records, also a
  ``record_function`` of the same name, so it shows inside the trace.
* ``recording()`` — whether a profiler session records.  The solve path
  (the solver loop, the preconditioner's apply, the kernel wrappers) opens
  its spans only then, testing this once a call; set-up opens them always.

``torch.profiler`` stamps host events with ``CLOCK_REALTIME`` in ns, which
``time.time_ns()`` reads, so a span's times compare with a trace's events.
The log is bounded: once :data:`CAPACITY` spans are kept, each new one
drops the oldest, and the drops are counted.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["trace", "annotate", "recording", "spans", "Span", "SpanLog"]

CAPACITY = 2**18  # spans kept; each holds ~100 bytes

# Whether a profiler session records; ~50 ns a call, and no allocation.
recording = torch.autograd._profiler_enabled


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


class Span(NamedTuple):
    """A closed span.  ``root`` is the id of the outermost span open around
    it (its own where none is), so every span of a solve run outside other
    spans carries the id of that solve's ``solver.solve``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    root: int


class SpanLog:
    """Closed spans in the order they closed, at most ``capacity``; when
    full, each new span drops the oldest and counts it."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def snapshot(self) -> tuple[list[Span], int]:
        with self._lock:
            return list(self._spans), self._dropped


_LOG = SpanLog()
_ids = itertools.count(1)
_open = threading.local()  # each thread's stack of open spans


def spans() -> tuple[list[Span], int]:
    """The process's span log, oldest first, and the number of spans dropped
    from it."""
    return _LOG.snapshot()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "region")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.region = None
        if recording():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.start_ns = time.time_ns()  # inside the region, so the region holds it
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self.region is not None:
            self.region.__exit__(*exc)
        _open.stack.pop()
        _LOG.add(Span(self.id, self.name, self.start_ns, end_ns, self.parent, self.root))
        return False


def annotate(name: str) -> _Open:
    """A span (``with annotate("mesh.build"): ...``), kept in the log of
    :func:`spans`; a ``record_function`` too while a profiler records."""
    return _Open(name)
