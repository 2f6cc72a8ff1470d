"""The distributed Navier–Stokes projection of stormx_torch — the
partitioned pressure solve of ``NsProjection(num_parts > 1)`` and the
whole step of ``stormx_torch.parallel.ns.ShardedNsProjection`` — against
the port's serial step and the JAX package's, on
``tests/test_navier_stokes.py``'s mesh and Taylor–Green field, float64,
with CPU thread ranks over gloo.

Tolerances are ``tests/test_navier_stokes.py``'s: against the serial step,
p within 1e-7 and the velocity within 5e-6 (the partitioned operator sums
rows in another order, so the Krylov trajectories part at rounding level,
and the LSQ corrector amplifies p's noise by ~1/h); IDR(s) and
BiCGStab(l) pressures within 1e-6 of each other; IDR(s) at P = 1 and 8
within 2 iterations, its first 10 history entries within 1e-9.  Against
the JAX package's distributed steps the port is held to its serial step's
own gap to the JAX serial step plus those tolerances: that gap comes from
the two corner cells whose LSQ systems are singular
(``tests/test_torch_euler.py::test_ns_predictor_matches_jax``), whose
gradients no two summation orders agree on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.apps.navier_stokes import NsProjection as JNs
from stormx.parallel.ns import ShardedNsProjection as JSharded
from stormx.solvers import SolverOptions as JOptions
from stormx_torch.apps.navier_stokes import NsProjection
from stormx_torch.parallel.ns import ShardedNsProjection
from stormx_torch.solvers import SolverOptions

from _torch_parallel_cases import index_gathers, np_, ranks, taylor_green, tri_mesh_pair

F64 = torch.float64
CPU = dict(device="cpu")
DT = 1e-2
OPTS = dict(num_iterations=800, absolute_tolerance=1e-11, relative_tolerance=1e-11)
P_TOL, V_TOL = 1e-7, 5e-6


def _kw():
    return {"options": SolverOptions(**OPTS)}


def _gap(a, b):
    return float(np.abs(np_(a) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def case():
    """Meshes, the field, and each package's serial BiCGStab(l) step."""
    jm, tm = tri_mesh_pair(12, 12)
    vel0 = taylor_green(tm.cell_centers)
    ser = NsProjection(tm, method="bicgstab_l", solver_kw=_kw(), dtype=F64, **CPU)
    v_s, p_s, r_s, _ = ser.step(torch.as_tensor(vel0), DT)
    jv, jp, jr, _ = JNs(jm, method="bicgstab_l", solver_kw={"options": JOptions(**OPTS)}).step(
        jnp.asarray(vel0), DT)
    assert r_s.converged and bool(jr.converged)
    return dict(jm=jm, tm=tm, vel0=vel0, v=v_s, p=p_s, p_gap=_gap(p_s, jp), v_gap=_gap(v_s, jv))


def _partitioned(case, method, p):
    outs = ranks(p, lambda mesh: NsProjection(
        case["tm"], method=method, num_parts=p, solver_kw=_kw(), dtype=F64, device_mesh=mesh,
        **CPU).step(torch.as_tensor(case["vel0"]), DT))
    for o in outs[1:]:
        assert torch.equal(o[1], outs[0][1])
    return outs[0]


def _sharded(case, method, p, **kw):
    outs = ranks(p, lambda mesh: ShardedNsProjection(
        case["tm"], num_parts=p, method=method, solver_kw=kw.get("solver_kw", _kw()), dtype=F64,
        device_mesh=mesh).step(torch.as_tensor(case["vel0"]), DT))
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
    return outs[0]


@pytest.mark.parametrize("method", ["idrs", "bicgstab_l"])
def test_partitioned_pressure_solve(case, method):
    """``test_partitioned_pressure_solve``: P = 8 against the serial step,
    and against the JAX package's partitioned step."""
    serial = NsProjection(case["tm"], method=method, solver_kw=_kw(), dtype=F64, **CPU)
    v_s, p_s, r_s, _ = serial.step(torch.as_tensor(case["vel0"]), DT)
    v_d, p_d, r_d, _ = _partitioned(case, method, 8)
    assert r_s.converged and r_d.converged
    assert _gap(p_d, np_(p_s)) <= P_TOL and _gap(v_d, np_(v_s)) <= V_TOL
    jv, jp, jr, _ = JNs(case["jm"], method=method, num_parts=8,
                        solver_kw={"options": JOptions(**OPTS)}).step(
        jnp.asarray(case["vel0"]), DT)
    assert bool(jr.converged)
    assert _gap(p_d, jp) <= case["p_gap"] + P_TOL
    assert _gap(v_d, jv) <= case["v_gap"] + V_TOL


def test_idrs_vs_bicgstabl_same_pressure(case):
    sols = {m: _partitioned(case, m, 4) for m in ("idrs", "bicgstab_l")}
    for m, (_, _, res, _) in sols.items():
        assert res.converged, m
    assert _gap(sols["idrs"][1], np_(sols["bicgstab_l"][1])) <= 1e-6


@pytest.mark.parametrize("p", [1, 4, 8])
def test_fully_sharded_step_matches_serial(case, p):
    """``test_fully_sharded_step_matches_serial``: the whole step on the
    ranks against the serial step; its iterations within 2 of the JAX
    sharded step's and its values within the serial gap of them."""
    v_d, p_d, r_d = _sharded(case, "bicgstab_l", p)
    assert r_d.converged
    assert _gap(p_d, np_(case["p"])) <= P_TOL and _gap(v_d, np_(case["v"])) <= V_TOL
    jv, jp, jr = JSharded(case["jm"], num_parts=p, method="bicgstab_l",
                          solver_kw={"options": JOptions(**OPTS)}).step(
        jnp.asarray(case["vel0"]), DT)
    assert abs(r_d.num_iterations - int(jr.num_iterations)) <= 2
    assert _gap(p_d, jp) <= case["p_gap"] + P_TOL
    assert _gap(v_d, jv) <= case["v_gap"] + V_TOL
    assert r_d.x.shape == p_d.shape == (case["tm"].num_cells,)


def test_fully_sharded_idrs_partition_invariant(case):
    """``test_fully_sharded_idrs_partition_invariant``: the global-layout
    shadow space makes P = 1 and P = 8 agree."""
    out = {p: _sharded(case, "idrs", p) for p in (1, 8)}
    (v1, p1, r1), (v8, p8, r8) = out[1], out[8]
    assert r1.converged and r8.converged
    assert abs(r1.num_iterations - r8.num_iterations) <= 2
    h1, h8 = np_(r1.history)[:10], np_(r8.history)[:10]
    assert np.nanmax(np.abs(h8 - h1) / h1) < 1e-9
    assert _gap(p8, np_(p1)) <= P_TOL and _gap(v8, np_(v1)) <= V_TOL


def test_building_the_step_twice_keeps_options_and_shadow_seed(case):
    """The JAX step pops ``options`` and ``shadow_seed`` from its
    ``solver_kw``, so a second build runs with the defaults; the port reads
    both and keeps them: two builds give the same step, the options' cap
    holds, and the seed is the one asked for."""
    def run(seed):
        kw = {"options": SolverOptions(num_iterations=5, absolute_tolerance=0.0,
                                       relative_tolerance=0.0), "shadow_seed": seed}

        def job(mesh):
            ns = ShardedNsProjection(case["tm"], num_parts=2, method="idrs", solver_kw=kw,
                                     dtype=F64, device_mesh=mesh)
            first = ns.step(torch.as_tensor(case["vel0"]), DT)
            ns._step = None  # build the step again
            second = ns.step(torch.as_tensor(case["vel0"]), DT)
            return first, second, dict(ns.solver_kw)

        return ranks(2, job)[0]

    first, second, kw_after = run(7)
    assert set(kw_after) == {"options", "shadow_seed"} and kw_after["shadow_seed"] == 7
    assert first[2].num_iterations == second[2].num_iterations == 5
    for a, b in zip(first[:2], second[:2]):
        assert torch.equal(a, b)
    other = run(8)[0]
    assert not torch.equal(other[1], first[1])


def test_sharded_step_through_k3_plans(case, monkeypatch):
    """The rank's gathers through K3's plans (their plain version here)
    give the step of tensor indexing, bit for bit."""
    got = _sharded(case, "bicgstab_l", 4)
    index_gathers(monkeypatch)
    want = _sharded(case, "bicgstab_l", 4)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)


def test_partition_velocity_round_trip(case):
    ns = ranks(1, lambda mesh: ShardedNsProjection(case["tm"], num_parts=1, method="cg",
                                                   dtype=F64, device_mesh=mesh))[0]
    vel = torch.as_tensor(case["vel0"])
    vp = ns.partition_velocity(vel)
    assert vp.shape == (1, ns.pfv.n_loc, 2)
    assert torch.equal(ns.unpartition(vp), vel)
