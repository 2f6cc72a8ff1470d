"""The traced window: ``torch.profiler`` over the benchmark's own spans, and
its reduction to device operations, each tagged with the span the host was
in when it launched the operation.

Spans are ``record_function`` ranges that the systems open around the calls
into each layer (:data:`SPANS`, innermost first) and the harness around the
whole window (``window``).  A device operation's launch time is that of its
CUDA runtime call (same correlation id), or else that of the host event it
is linked to; the innermost span holding that time is the operation's span.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

WINDOW = "window"
SPANS = ("precond", "operator", "rhs", "solve")  # innermost first
TOP = 10  # entries of each list of the breakdown


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    span: str  # innermost benchmark span at its launch, or "" for none

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass
class Trace:
    """A reduced trace: the device operations inside the window, and the
    host intervals of each span."""

    window: tuple[int, int]
    ops: list[DeviceOp]
    spans: dict[str, list[tuple[int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the operations' intervals, clipped to the window."""
        lo, hi = self.window
        merged: list[list[int]] = []
        for op in sorted(self.ops, key=lambda o: o.start_ns):
            s, e = max(op.start_ns, lo), min(op.end_ns, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def span_at(self, t_ns: int) -> str:
        """The innermost span that holds host time ``t_ns``, or ""."""
        for name in SPANS:
            iv = self.spans.get(name, [])
            k = bisect.bisect_right(iv, (t_ns, float("inf"))) - 1
            if k >= 0 and iv[k][0] <= t_ns <= iv[k][1]:
                return name
        return ""

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Idle time of the device inside the window, summed by the span the
        host was in when each gap began; longest first."""
        lo, hi = self.window
        by_label: dict[str, list] = {}
        t = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > t:
                label = self.span_at(t) or "outside the spans"
                acc = by_label.setdefault(label, [0, 0])
                acc[0] += s - t
                acc[1] += 1
            t = max(t, e)
        rows = [(f"{k} ({n} gaps)", ns * 1e-9) for k, (ns, n) in by_label.items()]
        return sorted(rows, key=lambda r: -r[1])[:TOP]

    def device_ops(self) -> list[tuple[str, float]]:
        """Device seconds by operation name; largest first."""
        acc: dict[str, float] = {}
        for op in self.ops:
            acc[op.name] = acc.get(op.name, 0.0) + op.seconds
        return sorted(acc.items(), key=lambda r: -r[1])[:TOP]

    def count(self, name: str) -> int:
        """Instances of a span in the window."""
        return len(self.spans.get(name, []))


def profile(fn, device):
    """Run ``fn`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activity); returns (fn's result, the profiler's raw events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return out, prof.profiler.kineto_results.events()


def reduce(events) -> Trace:
    """Reduce the raw events of :func:`profile` to a :class:`Trace`."""
    DT = torch.autograd.DeviceType
    spans: dict[str, list] = {}
    host_start: dict[int, int] = {}  # correlation id -> start of a host event
    runtime_start: dict[int, int] = {}  # correlation id -> start of a CUDA runtime call
    device = []
    for e in events:
        dt = e.device_type()
        if dt == DT.CPU:
            start, corr = e.start_ns(), e.correlation_id()
            name = e.name()
            if e.is_user_annotation() and (name in SPANS or name == WINDOW):
                spans.setdefault(name, []).append((start, e.end_ns()))
            if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
                runtime_start[corr] = start
            host_start.setdefault(corr, start)
        elif dt == DT.CUDA and not e.is_user_annotation() and e.name() not in SPANS + (WINDOW,):
            # (a span's projection onto the device's timeline is no operation)
            device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(),
                           e.linked_correlation_id()))
    for iv in spans.values():
        iv.sort()
    if WINDOW not in spans:
        raise RuntimeError("the trace holds no window span: its host events were lost")
    window = spans.pop(WINDOW)[0]
    trace = Trace(window=window, ops=[], spans=spans)
    for name, s, e, corr, linked in device:
        if e <= window[0] or s >= window[1]:
            continue
        t = runtime_start.get(corr)
        if t is None:
            t = host_start.get(linked)
        trace.ops.append(DeviceOp(name=name, start_ns=s, end_ns=e,
                                  span="" if t is None else trace.span_at(t)))
    return trace
