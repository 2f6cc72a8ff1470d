"""The program's own spans (``stormx_torch.core.profiling.spans()``) in a
traced run, and the card's idle time split between them.

The program stamps its spans on the profiler's host clock, so they compare
with the reduced trace's window and the benchmark's spans.  The device
operations' times are not on that clock throughout: the profiler maps the
card's clock onto the host's piece by piece, and within a piece the two
drift apart by up to ~6 µs a ms, then jump back (PERF.md §6).  So
each idle gap of the card (the window less ``Trace.busy_intervals()``) is
first moved onto the host's clock by the offset at the blocking reads: the
n-th ``solver.read`` span ends once the n-th device-to-host copy launched in
the benchmark's ``solve`` span (outside its inner spans) has ended.  Then
it is split between the innermost program spans the host was in over each
part of it, a span's self time; the part in no program span is "outside".

A program without the span log (an older checkout) gives nothing to read,
as does a log that dropped spans inside the window.
"""

from __future__ import annotations

import bisect
import heapq

SOLVE, ITERATE, READ = "solver.solve", "solver.iterate", "solver.read"
# Reads on each side whose least offset a read's offset takes: the host's
# time in a read after its copy ends only adds to the offset.
NEIGHBOURS = 2


def _log():
    try:
        from stormx_torch.core.profiling import spans
    except ImportError:
        return None
    return spans()


def in_window(run) -> list | None:
    """The program's spans inside the traced window, or None: no trace, no
    span log, or spans dropped from the log inside the window."""
    if run.trace is None:
        return None
    log = _log()
    if log is None:
        return None
    spans, dropped = log
    lo, hi = run.trace.window
    # The log drops the spans that closed first: none of the window's while
    # the oldest kept one closed before the window opened.
    if dropped and (not spans or spans[0].end_ns >= lo):
        return None
    return [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]


def setup_seconds(run, name: str) -> float | None:
    """Host seconds of the last span ``name`` that closed before the traced
    window opened (the set-up of the run's program)."""
    if run.trace is None:
        return None
    log = _log()
    if log is None:
        return None
    lo = run.trace.window[0]
    found = [s for s in log[0] if s.name == name and s.end_ns <= lo]
    return (found[-1].end_ns - found[-1].start_ns) * 1e-9 if found else None


def mean_us(run, name: str) -> float | None:
    """Mean host microseconds of the window's spans ``name``."""
    spans = in_window(run)
    found = [s for s in spans or () if s.name == name]
    if not found:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in found) / len(found)


def per_iteration(run, name: str) -> float | None:
    """The window's spans ``name`` per Krylov iteration."""
    spans = in_window(run)
    if not spans or run.iterations == 0:
        return None
    n = sum(1 for s in spans if s.name == name)
    return n / run.iterations if n else None


def _gaps(trace) -> list[tuple[int, int]]:
    lo, hi = trace.window
    out, t = [], lo
    for s, e in trace.busy_intervals() + [(hi, hi)]:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    return out


def _innermost(spans) -> list[tuple[int, int, int]]:
    """(start, end, id of the innermost span) over the union of ``spans``,
    in order.  Spans nest, and a span opened later has the larger id, so
    the innermost open span is the open one with the largest id."""
    events = sorted([(s.start_ns, 1, s.id) for s in spans]
                    + [(s.end_ns, 0, s.id) for s in spans])
    heap: list[int] = []
    closed: set[int] = set()
    out = []
    prev = None
    for t, opens, sid in events:
        if prev is not None and t > prev:
            while heap and -heap[0] in closed:
                closed.discard(-heapq.heappop(heap))
            if heap:
                out.append((prev, t, -heap[0]))
        if opens:
            heapq.heappush(heap, -sid)
        else:
            closed.add(sid)
        prev = t
    return out


def host_offsets(run, spans) -> tuple[list, list] | None:
    """The device ends of the copies the window's reads waited on, and at
    each the host clock less the device clock (the least over
    :data:`NEIGHBOURS` reads each side); None where the reads and the
    copies differ in number (the profiler lost a copy's record)."""
    ends = sorted(s.end_ns for s in spans if s.name == READ)
    copies = sorted(op.end_ns for op in run.trace.ops
                    if op.span == "solve" and "DtoH" in op.name)
    if not ends or len(ends) != len(copies):
        return None
    raw = [h - d for h, d in zip(ends, copies)]
    return copies, [min(raw[max(0, k - NEIGHBOURS):k + NEIGHBOURS + 1])
                    for k in range(len(raw))]


def idle_by_span(run) -> tuple[dict, dict] | None:
    """The card's idle ns in the window by the innermost program span the
    host was in ({span id: ns}, None for outside every program span), and
    the window's spans by id; None where there is nothing to read.  Each gap
    moves by the offset at the first read whose copy ends at or after the
    gap's start (by none where :func:`host_offsets` finds no offsets)."""
    spans = in_window(run)
    if not spans or not run.trace.ops:
        return None
    segments = _innermost(spans)
    starts = [s for s, _, _ in segments]
    copies, offsets = host_offsets(run, spans) or ([], [])
    idle: dict = {}
    for a, b in _gaps(run.trace):
        if copies:
            shift = offsets[min(bisect.bisect_left(copies, a), len(copies) - 1)]
            a, b = a + shift, b + shift
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segments) and segments[i][0] < b:
            s, e, sid = segments[i]
            part = min(e, b) - max(s, a)
            if part > 0:
                idle[sid] = idle.get(sid, 0) + part
                covered += part
            i += 1
        idle[None] = idle.get(None, 0) + (b - a) - covered
    return idle, {s.id: s for s in spans}


def idle_split(run) -> dict | None:
    """The card's idle ns in the window, by where the host was: ``read``
    (inside ``solver.read``), ``dispatch`` (inside ``solver.iterate`` and
    the spans nested in it), ``solve`` (the rest of ``solver.solve``: its
    set-up, finish and loop), ``other`` (other program spans) and
    ``outside`` (no program span).  The parts add up to the idle time."""
    found = idle_by_span(run)
    if found is None:
        return None
    idle, by_id = found
    split = dict.fromkeys(("read", "dispatch", "solve", "other", "outside"), 0)
    for sid, ns in idle.items():
        split[_part(sid, by_id)] += ns
    return split


def _part(sid, by_id) -> str:
    if sid is None:
        return "outside"
    names = []
    while sid is not None and sid in by_id:
        names.append(by_id[sid].name)
        sid = by_id[sid].parent
    for name, part in ((READ, "read"), (ITERATE, "dispatch"), (SOLVE, "solve")):
        if name in names:
            return part
    return "other"


def idle_us_per_iter(run, part: str) -> float | None:
    """Idle microseconds of the card a Krylov iteration in ``part`` of
    :func:`idle_split`."""
    split = idle_split(run)
    if split is None or run.iterations == 0:
        return None
    return 1e-3 * split[part] / run.iterations
