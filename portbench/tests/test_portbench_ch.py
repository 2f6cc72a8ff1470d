"""The ``ch_march`` cell on the CPU: the plain reference's D against a hand
assembly and the port's ``assemble_divgrad``, the program's step against a
dense float64 solve of the reference's A, and whole runs of a small copy of
the cell (``tiny_ch``), whose control and a fault come out not correct.

``tiny_ch`` is ``ch_march`` on a 28 × 28 grid's mesh (1,458 cells) with
``atol`` 1e-3 for 10: on that mesh A is far less stiff (its largest
eigenvalue grows as h⁻⁴), and 1e-3 keeps each step at 50 or more CG
iterations, as 10 keeps the 318k steps at thousands.  Its ``ch_res`` limit
is the cell's, scaled by the same factor, as the residual is absolute."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.inputs.mesh import delaunay_mesh
from portbench.reference import ch_playground as ref
from portbench.tests.tiny import REPO, copy_bench

CONFIG = os.path.join(REPO, "portbench", "configs", "ch_playground_tri318k.json")
TINY_SIDE, TINY_ATOL = 28, 1e-3
F64 = torch.float64


def config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with ``tiny_ch`` added as new files, and in
    the workloads of every metric that lists ``ch_march``."""
    root = copy_bench(str(tmp_path_factory.mktemp("ch") / "checkout"))
    pb = os.path.join(root, "portbench")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    big = next(w for w in spec["workloads"] if w["name"] == "ch_march")
    src = next(c for c in spec["configs"] if c["name"] == big["config"])
    cfg = config()
    scale = TINY_ATOL / cfg["atol"]
    cfg.update(name="tiny_ch318", grid_side=TINY_SIDE, atol=TINY_ATOL)
    rel = "portbench/configs/tiny_ch318.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(cfg, f)
    spec["configs"].append(dict(src, name="tiny_ch318", file=rel,
                                reduced=["atol", "grid_side"]))
    spec["workloads"].append(dict(big, name="tiny_ch", config="tiny_ch318"))
    with open(os.path.join(pb, "limits", "ch_march.json")) as f:
        limits = json.load(f)
    limits["ch_res"] *= scale
    with open(os.path.join(pb, "limits", "tiny_ch.json"), "w") as f:
        json.dump(limits, f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ch_march" in m.get("workloads", []):
            m["workloads"].append("tiny_ch")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)
    return root


def run(root, trace=False, seed=2**33 + 11, seconds=0.2, **kw):
    return harness.run_cell("tiny_ch", seed, seconds, trace, device="cpu",
                            bench=harness.Bench(root), **kw)


def hand_divgrad(points, tris):
    """D assembled triangle pair by triangle pair in plain Python: row i is
    Σ_e w_e (xⱼ − xᵢ) / Vᵢ, w_e = |edge| / |cᵢ − cⱼ|."""
    n = len(tris)
    D = np.zeros((n, n))
    centre = points[tris].mean(axis=1)
    area = np.zeros(n)
    owner = {}
    for c, t in enumerate(tris):
        a, b, d = points[t]
        area[c] = 0.5 * abs((b[0] - a[0]) * (d[1] - a[1]) - (b[1] - a[1]) * (d[0] - a[0]))
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            owner.setdefault(tuple(sorted(e)), []).append(c)
    for (p, q), cells in owner.items():
        if len(cells) == 2:
            i, j = cells
            w = np.linalg.norm(points[p] - points[q]) / np.linalg.norm(centre[i] - centre[j])
            D[i, j] += w / area[i]
            D[i, i] -= w / area[i]
            D[j, i] += w / area[j]
            D[j, j] -= w / area[j]
    return D


def dense_of(apply, n):
    eye = torch.eye(n, dtype=F64)
    return torch.stack([apply(eye[k].clone()) for k in range(n)], dim=1).numpy()


def program_mesh(points, tris):
    """The port's mesh of the raw triangles, ordered as the app orders it,
    and index[k] = the input triangle that is its cell k."""
    from portbench.systems.fv_diffusion import _cell_order
    from stormx_torch.mesh import build_mesh

    mesh = build_mesh(points, tris).optimize_ordering()
    return mesh, _cell_order(mesh, tris)


def test_reference_divgrad_is_the_hand_and_the_port_assembly():
    from stormx_torch.fvm.divgrad import assemble_divgrad

    points, tris = delaunay_mesh(5, 0.35, 0)
    step = ref.Step(points, tris, config(), "cpu")
    D = dense_of(step.D, len(tris))
    want = hand_divgrad(points, tris)
    np.testing.assert_allclose(D, want, rtol=1e-13, atol=1e-12 * np.abs(want).max())
    mesh, index = program_mesh(points, tris)
    port = assemble_divgrad(mesh).to_csr().todense().numpy()
    np.testing.assert_allclose(port, D[np.ix_(index, index)], rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    tau, gamma, sigma = (config()[k] for k in ("tau", "gamma", "sigma"))
    A = dense_of(step.A, len(tris))
    np.testing.assert_allclose(A, np.eye(len(tris)) - tau * sigma * want
                               + tau * gamma * want @ want, rtol=1e-12, atol=1e-12)


def test_program_step_is_the_reference_solve():
    """The app's assembled step in float64, to a tight tolerance, against a
    dense solve of the reference's A·c' = c − z, three steps in a row."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.solvers import SolverOptions

    cfg = config()
    points, tris = delaunay_mesh(12, 0.35, 0)
    mesh, index = program_mesh(points, tris)
    step = make_assembled_step(mesh, tau=cfg["tau"], gamma=cfg["gamma"], sigma=cfg["sigma"],
                               dtype=F64, device="cpu")
    opts = SolverOptions(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-13,
                         record_history=False)
    r = ref.Step(points, tris, cfg, "cpu")
    A = dense_of(r.A, len(tris))
    c = 0.5 + 0.1 * torch.as_tensor(np.random.default_rng(3).standard_normal(len(tris)))
    x = c[index]
    for _ in range(3):
        want = np.linalg.solve(A, r.rhs(c).numpy())
        x, res = step(x, options=opts)
        assert res.converged
        got = np.empty(len(tris))
        got[index] = x.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        c = torch.as_tensor(got)


def test_two_ring_entries_are_the_operators():
    from portbench.systems.ch_playground import two_ring_entries
    from stormx_torch.apps.cahn_hilliard import make_assembled_step

    points, tris = delaunay_mesh(9, 0.35, 0)
    mesh, _ = program_mesh(points, tris)
    op = make_assembled_step(mesh, dtype=F64, device="cpu").operator
    assert two_ring_entries(tris) == int((op.data != 0).sum())


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_ch_is_correct(tiny_root, trace):
    result, compared = run(tiny_root, trace=trace)
    assert result["correct"] is True, compared
    assert result["failed"] == 0 and result["attempted"] >= 3
    if trace:
        m = result["metrics"]
        assert m["krylov.iterations.step"]["value"] >= 50
        assert m["setup.assemble_s"]["value"] > 0 and m["setup.device_mesh_s"]["value"] > 0
        assert "k1_staged_roofline" not in m  # no K1 launch on the CPU
    else:
        assert set(result["metrics"]) == {"step_ms", "setup_s"}
    assert {n for n, _, _ in compared} == {"unconverged", "ch_res", "ch_mass"}


def test_each_tiny_step_runs_50_iterations(tiny_root):
    records = []

    def recording(c):
        system = c.program()
        inner = system.solve_next

        def solve_next():
            out = inner()
            records.append(out[2])
            return out
        system.solve_next = solve_next
        return system
    result, _ = run(tiny_root, make_system=recording)
    assert result["correct"] is True
    assert min(records[1:]) >= 50  # the first is the 3-iteration warm-up


def scaled_operator(c):
    """The program with its assembled A scaled by 1.001."""
    system = c.program()
    op = system.step.operator
    op.data.mul_(1.001)
    if op.dense_blocks is not None:
        op.dense_blocks.mul_(1.001)
    return system


@pytest.mark.parametrize("make", [lambda c: c.control(), scaled_operator],
                         ids=["bfloat16_control", "scaled_A"])
def test_tiny_ch_control_and_fault_are_not_correct(tiny_root, make):
    result, compared = run(tiny_root, make_system=make)
    assert result["correct"] is False, compared
