"""``stormx_torch.core.profiling``'s spans, on the CPU: the solve path
opens them only while a profiler records, set-up always; each holds its
parent, its root and its times on the profiler's clock; the log is bounded
and counts what it drops."""

import os
import re

import numpy as np
import pytest
import torch

from stormx_torch.core import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def new_spans(before: int) -> list:
    """Spans closed since the log held ``before`` (the log drops nothing
    while it holds fewer than its capacity)."""
    log, dropped = profiling.spans()
    assert dropped == 0
    return log[before:]


def heat_system(side: int = 6):
    """V + L of a small triangle mesh as a CSR (SPD), built as a user
    builds it: mesh, ordering, two-point Laplacian."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh.structured import structured_tri_rect
    from stormx_torch.sparse import CSR

    mesh = structured_tri_rect(side, side).optimize_ordering()
    lap = assemble_laplacian(mesh).to_csr()
    row_ptr, cols = lap.row_ptr.numpy(), lap.indices.numpy()
    rows = np.repeat(np.arange(mesh.num_cells), np.diff(row_ptr))
    data = lap.data.numpy() + np.where(cols == rows, 50.0 * mesh.cell_volumes[rows], 0.0)
    return CSR(data=data, indices=cols, row_ptr=row_ptr, shape=lap.shape)


def cg_ic0(csr, atol: float):
    from stormx_torch.precond import IcPreconditioner
    from stormx_torch.solvers import SolverOptions, solve

    precond = IcPreconditioner(csr, device="cpu")
    a = torch.sparse_csr_tensor(torch.as_tensor(csr.row_ptr), torch.as_tensor(csr.indices),
                                torch.as_tensor(csr.data), size=csr.shape)
    b = torch.linspace(-1.0, 1.0, csr.shape[0], dtype=torch.float64)
    opts = SolverOptions(num_iterations=200, absolute_tolerance=atol,
                         relative_tolerance=1e-10, record_history=False)

    def run():
        return solve(lambda x: a @ x, b, None, method="cg", precond=precond, options=opts)
    return run


def test_off_the_solve_path_records_nothing(monkeypatch):
    run = cg_ic0(heat_system(), atol=1e-12)
    before = len(profiling.spans()[0])

    def no_region(*args, **kwargs):
        raise AssertionError("a record_function while no profiler records")
    monkeypatch.setattr(torch.profiler, "record_function", no_region)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_region)
    res = run()
    assert res.converged and res.num_iterations > 1
    assert new_spans(before) == []


def test_profiled_solve_spans_each_iteration_read_and_apply():
    run = cg_ic0(heat_system(), atol=1e-12)
    before = len(profiling.spans()[0])
    with torch.profiler.profile() as prof:
        res = run()
    spans = new_spans(before)
    n = res.num_iterations
    assert res.converged and n > 1
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert {k: len(v) for k, v in by_name.items()} == {
        "solver.solve": 1, "solver.iterate": n, "solver.read": n + 1, "precond.apply": n + 1}
    solve = by_name["solver.solve"][0]
    assert solve.parent is None and solve.root == solve.id
    assert {s.root for s in spans} == {solve.id}
    iterates = {s.id for s in by_name["solver.iterate"]}
    assert all(s.parent == solve.id for s in by_name["solver.iterate"] + by_name["solver.read"])
    # CG's first apply is in its set-up, the others one in each iteration
    parents = [s.parent for s in by_name["precond.apply"]]
    assert parents[0] == solve.id and set(parents[1:]) == iterates
    for s in spans:
        parent = next((p for p in spans if p.id == s.parent), solve)
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # each span is also a record_function of its name
    names = [e.name for e in prof.events()]
    assert names.count("solver.iterate") == n and names.count("precond.apply") == n + 1


def test_no_pre_loop_read_without_atol():
    run = cg_ic0(heat_system(), atol=0.0)
    before = len(profiling.spans()[0])
    with torch.profiler.profile():
        res = run()
    reads = [s for s in new_spans(before) if s.name == "solver.read"]
    assert len(reads) == res.num_iterations


def test_spans_share_the_profilers_clock():
    """A span opened inside the benchmark's window lies within the window
    as the profiler stamped it."""
    from portbench import trace as tracing

    before = len(profiling.spans()[0])

    def work():
        with profiling.annotate("probe.outer"):
            with profiling.annotate("probe.inner"):
                torch.arange(64.0).sum()

    _, events = tracing.profile(work, "cpu")
    lo, hi = tracing.reduce(events).window
    spans = new_spans(before)
    assert [s.name for s in spans] == ["probe.inner", "probe.outer"]
    assert all(lo <= s.start_ns <= s.end_ns <= hi for s in spans)
    regions = {e.name(): (e.start_ns(), e.end_ns()) for e in events
               if e.name().startswith("probe.")}
    for s in spans:
        start, end = regions[s.name]
        assert start <= s.start_ns <= s.end_ns <= end


def test_setup_spans_are_recorded_without_a_profiler():
    from stormx_torch.precond import IcPreconditioner
    from stormx_torch.sparse import auto_operator

    assert not profiling.recording()
    before = len(profiling.spans()[0])
    csr = heat_system(side=5)
    auto_operator(csr, device="cpu")
    IcPreconditioner(csr, device="cpu")
    names = [s.name for s in new_spans(before)]
    assert names == ["mesh.build", "mesh.order", "operator.build", "precond.factor",
                     "precond.levels"]


def ch_mesh():
    from stormx_torch.mesh.structured import structured_tri_rect

    return structured_tri_rect(6, 6).optimize_ordering()


def test_ch_setup_spans_are_recorded_without_a_profiler():
    """``make_assembled_step`` keeps ``ch.assemble`` (assembly of A),
    ``operator.build`` and ``mesh.device`` (``device_arrays``)."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step

    mesh = ch_mesh()
    assert not profiling.recording()
    before = len(profiling.spans()[0])
    make_assembled_step(mesh, dtype=torch.float64, device="cpu")
    assert [s.name for s in new_spans(before)] == ["ch.assemble", "operator.build",
                                                   "mesh.device"]
    before = len(profiling.spans()[0])
    mesh.device_arrays(dtype=torch.float64, device="cpu", banded_gather=True)
    assert [s.name for s in new_spans(before)] == ["mesh.device"]


@pytest.mark.parametrize("assembled", [False, True])
def test_ch_step_spans_only_while_recording(assembled):
    """A CH step opens no span off the profiler; while it records, one
    ``ch.step`` holds ``ch.rhs`` and then the solve's ``solver.solve``."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step, make_step
    from stormx_torch.solvers import SolverOptions

    mesh = ch_mesh()
    opts = SolverOptions(num_iterations=4, absolute_tolerance=0.0, relative_tolerance=1e-12)
    if assembled:
        step = make_assembled_step(mesh, options=opts, dtype=torch.float64, device="cpu")
    else:
        step = make_step(mesh.device_arrays(dtype=torch.float64, device="cpu"), options=opts,
                         device="cpu")
    c = 0.5 + 0.1 * torch.as_tensor(np.random.default_rng(0).standard_normal(mesh.num_cells))
    before = len(profiling.spans()[0])
    _, res = step(c)
    assert res.num_iterations == 4 and new_spans(before) == []
    with torch.profiler.profile():
        step(c)
    spans = new_spans(before)
    by_name: dict = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (outer,), (rhs,), (solve,) = by_name["ch.step"], by_name["ch.rhs"], by_name["solver.solve"]
    assert spans[0] is rhs and spans[-1] is outer
    assert outer.parent is None and rhs.parent == outer.id and solve.parent == outer.id
    assert rhs.end_ns <= solve.start_ns
    assert len(by_name["solver.iterate"]) == 4
    assert all(s.root == outer.id for s in spans)


def test_the_log_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", profiling.SpanLog(capacity=3))
    for k in range(5):
        with profiling.annotate(f"s{k}"):
            pass
    log, dropped = profiling.spans()
    assert [s.name for s in log] == ["s2", "s3", "s4"] and dropped == 2


class _Sell:
    """A SlicedELL's fields as ``sell_spmv_cuda`` reads them, on the CPU."""

    data = local_cols = torch.zeros(1, 1, 4)
    shape = (4, 4)


def call_wrapper(name: str):
    from stormx_torch.ops import sell_spmv, tri_solve

    if name == "t1.launch":
        return tri_solve.exact_cuda(None, torch.zeros(4))
    return sell_spmv.sell_spmv_cuda(_Sell(), torch.zeros(4))


@pytest.mark.parametrize("name", ["t1.launch", "k1.launch"])
def test_a_wrapper_is_a_span_only_while_recording(name):
    """The kernel wrappers refuse CPU tensors; the span still closes, and
    the next span's parent is not left pointing at it."""
    before = len(profiling.spans()[0])
    with pytest.raises(ValueError):
        call_wrapper(name)
    assert new_spans(before) == []
    with torch.profiler.profile():
        with pytest.raises(ValueError):
            call_wrapper(name)
        with profiling.annotate("after"):
            pass
    spans = new_spans(before)
    assert [s.name for s in spans] == [name, "after"]
    assert spans[1].parent is None


def test_no_program_span_takes_a_benchmark_span_name():
    """``portbench/trace.py`` reads ``solve``, ``operator``, ``precond``,
    ``rhs`` and ``window`` as the benchmark's own spans."""
    from portbench import trace as tracing

    found = set()
    for d, _, files in os.walk(os.path.join(REPO, "stormx_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    found |= set(re.findall(r'annotate\("([^"]+)"\)', fh.read()))
                    fh.seek(0)
                    found |= set(re.findall(r'_spanned\("([^"]+)"', fh.read()))
    assert {"solver.solve", "solver.iterate", "solver.read", "precond.apply", "t1.launch",
            "k1.launch", "mesh.build", "operator.build", "precond.factor"} <= found
    assert not found & (set(tracing.SPANS) | {tracing.WINDOW})
