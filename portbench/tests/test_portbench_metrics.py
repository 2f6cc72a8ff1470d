"""The byte counts against hand counts, the trace's reduction, and each
per-layer metric's arithmetic on a small recorded trace."""

import os

import pytest
import torch

from portbench import harness
from portbench import trace as tracing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = harness.Bench(REPO)
KERNELS = BENCH.kernels()
PEAK = 3.35e12


# -- byte counts -----------------------------------------------------------------

@pytest.mark.parametrize("kid, shape, hand", [
    # 3 rows, 7 entries of float32 and int32 columns, x and y: 7*8 + 2*3*4
    ("k1", {"rows": 3, "entries": 7}, 56 + 24),
    # a 2 x 2 grid's five-point operator: 12 non-zeros of float32, x and y
    ("k2a", {"rows": 4, "entries": 12}, 48 + 32),
    # 5 rows, 4 off-diagonal entries (value, column), diagonal, r and y
    ("t1", {"rows": 5, "entries": 4}, 32 + 3 * 20),
])
def test_bytes_against_hand_counts(kid, shape, hand):
    assert KERNELS[kid].bytes_per_call(shape) == hand


def test_shapes_of_the_inputs():
    from portbench.inputs.grid import poisson5_diags, poisson5_nonzeros
    from portbench.inputs.mesh import delaunay_mesh, interior_edges

    for nx in (2, 3, 7):
        _, data = poisson5_diags(nx)
        assert poisson5_nonzeros(nx) == int((data != 0).sum())
    _, tris = delaunay_mesh(6, 0.35, 0)
    # Euler: a triangulation of a convex point set has 3T = 2E_int + E_boundary,
    # and its boundary edges are the hull's 4 * (side - 1).
    assert interior_edges(tris) == (3 * len(tris) - 4 * 5) // 2


# -- the reduction ----------------------------------------------------------------

class Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, dev, start, end, corr=0, linked=0, user=False):
        self._v = (name, dev, start, end, corr, linked, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def recorded():
    """Two CG iterations of a window 0..1000 ns: in each, an operator span
    launching K2a, a precond span launching T1, and a dot in the solve."""
    ev = [Ev("window", CPU, 0, 1000, 1, user=True)]
    corr = 100
    for k, base in enumerate((0, 500)):
        ev.append(Ev("solve", CPU, base + 10, base + 490, 2 + 10 * k, user=True))
        ev.append(Ev("operator", CPU, base + 20, base + 60, 3 + 10 * k, user=True))
        ev.append(Ev("precond", CPU, base + 100, base + 200, 4 + 10 * k, user=True))
        # runtime calls and their kernels, by CUPTI correlation
        for t_host, t_dev, dur, name in ((30, 50, 40, "dia_spmv_kernel<float, false>"),
                                         (110, 150, 100, "void tri_exact_kernel<float>"),
                                         (300, 320, 20, "void dot_kernel")):
            corr += 1
            ev.append(Ev("cudaLaunchKernel", CPU, base + t_host, base + t_host + 5, corr))
            ev.append(Ev(name, CUDA, base + t_dev, base + t_dev + dur, corr))
    # a kernel whose runtime call is missing: placed by the host op it links to
    ev.append(Ev("aten::mul", CPU, 800, 810, 77))
    ev.append(Ev("void mul_kernel", CUDA, 940, 950, 9999, 77))
    return ev


def test_reduce_attributes_each_kernel_to_its_span():
    tr = tracing.reduce(recorded())
    by = {}
    for op in tr.ops:
        by.setdefault(op.span, []).append(op.name)
    assert sorted(by) == ["operator", "precond", "solve"]
    assert len(by["operator"]) == 2 and len(by["precond"]) == 2 and len(by["solve"]) == 3
    assert tr.count("precond") == 2 and tr.window == (0, 1000)
    # busy: 2 x (40 + 100 + 20) + 10 = 330 ns of 1000
    assert tr.busy_s() == pytest.approx(330e-9)
    gaps = dict((k.split(" (")[0], v) for k, v in tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(670e-9)
    ops = dict(tr.device_ops())
    assert ops["void tri_exact_kernel<float>"] == pytest.approx(200e-9)


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError):
        tracing.reduce([e for e in recorded() if e.name() != "window"])


def run_of(trace, **kw):
    base = dict(workload="w", records=[(0, 1, True), (0, 1, True)],
                window_s=1.0, info={"k2a": {"rows": 4, "entries": 12},
                                    "t1": {"rows": 5, "entries": 4, "levels": 2}},
                setup_times={"mesh_s": 1.5}, trace=trace,
                peaks={"bytes_per_s": PEAK}, kernels=KERNELS)
    base.update(kw)
    return harness.Run(**base)


@pytest.mark.parametrize("name, expected", [
    ("krylov.iterations.step", 1.0),
    ("krylov.iterations.solve", 1.0),
    ("host.launches_per_iter.step", 7 / 2),
    ("algebra.us_per_iter.solve", (2 * 20 + 10) * 1e-3 / 2),
    ("precond.ms_per_apply", 100e-6),
    ("device.idle_share.step", 67.0),
    ("t1.ns_per_level", 100 / 2),
    ("t1_roofline", 100 * (92 / PEAK) / 100e-9),
    ("k2a_roofline", 100 * (80 / PEAK) / 40e-9),
    ("setup.mesh_s", 1.5),
])
def test_metric_arithmetic(name, expected):
    run = run_of(tracing.reduce(recorded()))
    assert BENCH.reader(name).read(run) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["host.launches_per_iter.solve", "algebra.us_per_iter.step",
                                  "precond.ms_per_apply", "device.idle_share.solve",
                                  "t1.ns_per_level", "t1_roofline", "k1_roofline",
                                  "k2a_roofline", "setup.precond_s"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert BENCH.reader(name).read(run_of(None, info={}, setup_times={})) is None


def test_no_roofline_without_a_peak():
    run = run_of(tracing.reduce(recorded()), peaks=None)
    assert BENCH.reader("t1_roofline").read(run) is None


def test_lost_records():
    tr = tracing.reduce(recorded())
    counted = {"k2a": 2, "t1": 2, "k1": 0}
    assert harness.lost_records(tr, KERNELS, dict.fromkeys(counted, 0), counted) == {}
    more = dict(counted, t1=3)
    assert harness.lost_records(tr, KERNELS, dict.fromkeys(counted, 0), more) == {"t1": (2, 3)}


def test_run_iterations():
    assert run_of(None, records=[(0, 3, True), (1, 4, False)]).iterations == 7
