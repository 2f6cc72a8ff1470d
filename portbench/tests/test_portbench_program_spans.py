"""The readers of the program's spans (``program_spans.py``): the idle split
and each metric's arithmetic on a synthetic trace and span log, nothing
to read without a trace, a span log or with spans dropped in the window,
and the metrics a traced CPU run of the small cells reports."""

import sys
import types

import pytest

from portbench import harness
from portbench import program_spans
from portbench import trace as tracing
from portbench.tests.tiny import REPO
from stormx_torch.core.profiling import Span

BENCH = harness.Bench(REPO)


def synthetic_log():
    """Set-up before a window of 0..1000 ns, then a solve of two CG
    iterations: a pre-loop read, an iteration holding a K1 call and an
    apply that holds a T1 call, a read, a second iteration and a read."""
    return [
        Span(1, "operator.build", -500, -300, None, 1),
        Span(2, "precond.factor", -280, -200, None, 2),
        Span(11, "solver.read", 110, 150, 10, 10),
        Span(13, "k1.launch", 160, 190, 12, 10),
        Span(15, "t1.launch", 210, 260, 14, 10),
        Span(14, "precond.apply", 200, 400, 12, 10),
        Span(12, "solver.iterate", 150, 500, 10, 10),
        Span(16, "solver.read", 500, 600, 10, 10),
        Span(17, "solver.iterate", 600, 800, 10, 10),
        Span(18, "solver.read", 800, 880, 10, 10),
        Span(10, "solver.solve", 100, 900, None, 10),
    ]


# busy [0,120] [170,230] [300,550] [650,700] [850,890] [950,1000]: gaps
# [120,170] read 30, iterate 10, K1 10; [230,300] T1 30, apply 40;
# [550,650] read 50, iterate 50; [700,850] iterate 100, read 50;
# [890,950] the solve's own 10, outside 50.
BUSY = [(0, 120), (170, 230), (300, 550), (650, 700), (850, 890), (950, 1000)]
SPLIT = {"read": 130, "dispatch": 240, "solve": 10, "other": 0, "outside": 50}


def synthetic_run(monkeypatch, log=None, dropped=0, busy=BUSY, trace=True):
    entries = synthetic_log() if log is None else log
    monkeypatch.setattr(program_spans, "_log", lambda: (entries, dropped))
    ops = [tracing.DeviceOp("k", s, e, "") for s, e in busy]
    return harness.Run(workload="w", records=[((0, 0), 2, True)], window_s=1e-6, info={},
                       setup_times={},
                       trace=tracing.Trace(window=(0, 1000), ops=ops) if trace else None)


def test_the_idle_split_adds_up_to_the_idle_time(monkeypatch):
    run = synthetic_run(monkeypatch)
    split = program_spans.idle_split(run)
    assert split == SPLIT
    idle_ns = 1000 - sum(e - s for s, e in BUSY)
    assert sum(split.values()) == idle_ns
    idle, by_id = program_spans.idle_by_span(run)
    assert idle == {11: 30, 12: 10, 13: 10, 15: 30, 14: 40, 16: 50, 17: 150, 18: 50,
                    10: 10, None: 50}
    assert sorted(by_id) == list(range(10, 19))


@pytest.mark.parametrize("name, expected", [
    ("host.syncs_per_iter.step", 3 / 2),
    ("host.syncs_per_iter.solve", 3 / 2),
    ("host.read_idle_us_per_iter.step", 130e-3 / 2),
    ("host.read_idle_us_per_iter.solve", 130e-3 / 2),
    ("host.dispatch_idle_us_per_iter.step", 240e-3 / 2),
    ("host.dispatch_idle_us_per_iter.solve", 240e-3 / 2),
    ("t1.host_us_per_call", 50e-3),
    ("k1.host_us_per_call", 30e-3),
    ("setup.operator_s", 200e-9),
    ("setup.precond_factor_s", 80e-9),
])
def test_reader_arithmetic(monkeypatch, name, expected):
    assert BENCH.reader(name).read(synthetic_run(monkeypatch)) == pytest.approx(expected)


NEW = ["host.syncs_per_iter.step", "host.read_idle_us_per_iter.solve",
       "host.dispatch_idle_us_per_iter.step", "t1.host_us_per_call", "k1.host_us_per_call",
       "setup.operator_s", "setup.precond_factor_s"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_without_a_trace_or_a_span_log(monkeypatch, name):
    assert BENCH.reader(name).read(synthetic_run(monkeypatch, trace=False)) is None
    assert BENCH.reader(name).read(synthetic_run(monkeypatch, log=[])) is None


@pytest.mark.parametrize("name", NEW[:5])
def test_nothing_to_read_with_spans_dropped_in_the_window(monkeypatch, name):
    # the oldest span kept closed inside the window: what was dropped may too
    inside = synthetic_log()[2:]
    assert BENCH.reader(name).read(synthetic_run(monkeypatch, log=inside, dropped=3)) is None
    # the oldest kept closed before the window: the drops are the set-up's
    assert BENCH.reader(name).read(synthetic_run(monkeypatch, dropped=3)) is not None


def test_gaps_move_onto_the_host_clock_at_the_reads(monkeypatch):
    """A device clock 120 ns behind the host's: the read ends at host 600,
    its copy at device 480.  Device gaps [300,450] and [480,700] are host
    [420,570] (in the read) and [600,820] (in the second iteration)."""
    log = [Span(2, "solver.iterate", 0, 400, 1, 1), Span(3, "solver.read", 400, 600, 1, 1),
           Span(4, "solver.iterate", 600, 1000, 1, 1), Span(1, "solver.solve", 0, 1000, None, 1)]
    run = synthetic_run(monkeypatch, log=log, busy=[(0, 300), (700, 1000)])
    run.trace.ops.append(tracing.DeviceOp("Memcpy DtoH (Device -> Pinned)", 450, 480, "solve"))
    assert program_spans.host_offsets(run, log) == ([480], [120])
    assert program_spans.idle_split(run) == {"read": 150, "dispatch": 220, "solve": 0,
                                             "other": 0, "outside": 0}
    # without a copy for the read, the gaps stay where the device put them
    run.trace.ops[-1] = tracing.DeviceOp("Memcpy DtoH (Device -> Pinned)", 450, 480, "rhs")
    assert program_spans.host_offsets(run, log) is None
    assert program_spans.idle_split(run)["read"] == 50 + 120


def test_a_reads_offset_is_the_least_of_its_neighbours(monkeypatch):
    """A read whose host returned late (a long tail) does not move the
    gaps: each offset is the least within NEIGHBOURS reads each side."""
    reads = [Span(10 + k, "solver.read", 100 * k + 50, 100 * k + 90 + (300 if k == 3 else 0),
                  None, 10 + k) for k in range(8)]
    run = synthetic_run(monkeypatch, log=reads, busy=[])
    run.trace.ops.extend(tracing.DeviceOp("Memcpy DtoH", 100 * k + 60, 100 * k + 80, "solve")
                         for k in range(8))
    copies, offsets = program_spans.host_offsets(run, reads)
    assert copies == [100 * k + 80 for k in range(8)] and offsets == [10] * 8


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """An older program's profiling module has no span log."""
    monkeypatch.setitem(sys.modules, "stormx_torch.core.profiling",
                        types.ModuleType("stormx_torch.core.profiling"))
    assert program_spans._log() is None


def test_no_idle_split_without_device_operations(monkeypatch):
    run = synthetic_run(monkeypatch, busy=[])
    assert program_spans.idle_split(run) is None
    assert BENCH.reader("host.syncs_per_iter.step").read(run) == 3 / 2


@pytest.mark.parametrize("cell, suffix", [("tiny_heat", ".step"), ("tiny_cg", ".solve")])
def test_a_traced_cpu_run_reports_the_host_metrics(tiny_root, cell, suffix):
    result, _ = harness.run_cell(cell, 2**33 + 7, 0.2, True, device="cpu",
                                 bench=harness.Bench(tiny_root))
    metrics = result["metrics"]
    assert metrics["host.syncs_per_iter" + suffix]["value"] >= 1.0
    if cell == "tiny_heat":
        # tolerance atol > 0: one read before the loop a step
        assert metrics["host.syncs_per_iter.step"]["value"] > 1.0
        assert metrics["setup.operator_s"]["value"] > 0
        assert 0 < metrics["setup.precond_factor_s"]["value"] < metrics["setup.precond_s"]["value"]
    else:
        assert metrics["host.syncs_per_iter.solve"]["value"] == 1.0
