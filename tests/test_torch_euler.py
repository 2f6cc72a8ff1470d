"""The port's FvSolver and explicit apps (``stormx_torch.fvm.solver``,
``stormx_torch.apps.euler``, ``laplace2d``, ``navier_stokes``) held against
the JAX package's on the same NumPy inputs, in float64 on the CPU.

Tolerances: forward-Euler marches within 1e-10 of the JAX ``march``,
relative to the largest state entry (1e-12 per step of XLA-vs-torch
summation order, compounded over 10 steps); JFNK's residual histories within
1e-8·‖r0‖ (its finite-difference product divides by δ ≈ 1.5e-8, so
rounding differences of 1e-16 in 𝓐 become 1e-8 in J·y, as in
``tests/test_torch_nonlinear.py``); Laplace2D within 1e-12 of the JAX field
and 1e-4 of the reference's goldens; the projection step within 1e-9 from the
same predicted velocity (its CG stops at 1e-11), the predictor within 1e-12
on the cells whose LSQ system is well posed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.fvm as J
from stormx.apps import euler as j_euler
from stormx.apps.laplace2d import laplace2d as j_laplace2d
from stormx.apps.navier_stokes import NsProjection as JNs
from stormx.apps.navier_stokes import cell_divergence as j_cell_divergence
from stormx.apps.navier_stokes import flux_divergence as j_flux_divergence
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx.solvers import SolverOptions as JOptions
import stormx_torch.fvm as T
from stormx_torch.apps import euler
from stormx_torch.apps.laplace2d import laplace2d, laplace2d_error
from stormx_torch.apps.navier_stokes import NsProjection, cell_divergence, flux_divergence
from stormx_torch.mesh import build_mesh, structured_tri_rect
from stormx_torch.solvers import SolverOptions
from tests.test_torch_fvm import assert_close, device_meshes, euler_state

F64 = torch.float64
CPU = dict(device="cpu")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bcs(pkg):
    return {1: pkg.far_field_bc, 2: pkg.slip_bc}


# -- FvSolver -----------------------------------------------------------------------


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
def test_march_matches_jax(order, banded, rng):
    td, jd = device_meshes("tri", banded)
    u0 = euler_state(rng, jd)
    ts = T.FvSolver(td, order=order, bcs=_bcs(T))
    js = J.FvSolver(jd, order=order, bcs=_bcs(J))
    got = ts.march(torch.as_tensor(u0), 1e-3, 10)
    assert_close(got, js.march(jnp.asarray(u0), 1e-3, 10), 1e-10)
    # The step function is the step itself, and a loop of steps is the march.
    step = ts.jitted_step()
    u = torch.as_tensor(u0)
    for _ in range(10):
        u = step(u, 1e-3)
    assert torch.equal(u, got)
    assert_close(ts.step(torch.as_tensor(u0), 1e-3), js.step(jnp.asarray(u0), 1e-3), 1e-12)


def test_solver_defaults():
    td, _ = device_meshes("tri", False)
    s = T.FvSolver(td)
    assert s.order == 2 and s.flux_scheme is T.lax_friedrichs_flux
    assert s.bcs == {1: T.far_field_bc, 2: T.slip_bc}
    assert T.FvSolver(td, order=1)._g_mats is None


def test_euler_app_matches_jax():
    m = structured_tri_rect(6, 5)
    jm = j_tri_rect(6, 5)
    np.testing.assert_array_equal(_np(euler.initial_state(m.num_cells, dtype=F64, **CPU)),
                                  np.asarray(j_euler.initial_state(m.num_cells)))
    td = m.device_arrays(F64, **CPU)
    got = euler.run(td, 5, dt=1e-3, bcs={1: T.far_field_bc})
    assert got.dtype == F64 and got.device.type == "cpu"
    assert_close(got, j_euler.run(jm.device_arrays(), 5, dt=1e-3, bcs={1: J.far_field_bc}), 1e-10)


def test_euler_app_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from stormx_torch.core.exceptions import StormError

    with pytest.raises(StormError, match="CUDA"):
        euler.initial_state(4)


# -- the Sod shock tube ------------------------------------------------------------


def _strip(nx):
    xs = np.linspace(0.0, 1.0, nx + 1)
    xx, yy = np.meshgrid(xs, np.array([0.0, 1.0 / nx]), indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = np.asarray([[2 * i, 2 * i + 2, 2 * i + 3, 2 * i + 1] for i in range(nx)])
    return build_mesh(pos, cells)


@pytest.mark.parametrize("scheme", ["hllc_flux", "hll_flux"])
def test_sod_shock_tube_plateaus(scheme):
    """The JAX package's gates (tests/test_fvm.py): the exact Riemann
    solution's plateaus at t = 0.2 (p* 0.30313, v* 0.92745, ρ*L 0.42632,
    ρ*R 0.26557, shock at 0.8504), 2000 first-order steps on a 400-cell
    quad strip."""
    mesh = _strip(400)
    dmesh = mesh.device_arrays(F64, **CPU)
    solver = T.FvSolver(dmesh, order=1, bcs={1: T.slip_bc}, flux_scheme=getattr(T, scheme))
    xc = _np(dmesh.cell_centers)[:, 0]
    prim = np.zeros((mesh.num_cells, 5))
    prim[xc < 0.5] = [1.0, 1.0, 0.0, 0.0, 0.0]
    prim[xc >= 0.5] = [0.125, 0.1, 0.0, 0.0, 0.0]
    n = torch.zeros((mesh.num_cells, 2), dtype=F64)
    n[:, 0] = 1.0
    u0 = T.state_from_prim(n, torch.as_tensor(prim)).make_cons()
    st = T.state_from_cons(n, solver.march(u0, 0.2 / 2000, 2000))
    order = np.argsort(xc)
    xs, rho, p, vx = xc[order], _np(st.rho)[order], _np(st.p)[order], _np(st.vel)[order, 0]

    def plateau(lo, hi, arr):
        return float(np.median(arr[(xs > lo) & (xs < hi)]))

    assert abs(plateau(0.72, 0.80, p) - 0.30313) < 0.01
    assert abs(plateau(0.72, 0.80, vx) - 0.92745) < 0.02
    assert abs(plateau(0.60, 0.66, rho) - 0.42632) < 0.02
    assert abs(plateau(0.72, 0.80, rho) - 0.26557) < 0.02
    assert abs(plateau(0.0, 0.15, rho) - 1.0) < 1e-6
    assert abs(plateau(0.92, 1.0, rho) - 0.125) < 1e-6
    mask = xs[:-1] > 0.75
    x_shock = xs[:-1][mask][np.argmax(np.abs(np.diff(rho))[mask])]
    assert abs(x_shock - 0.8504) < 0.03


# -- the implicit step ---------------------------------------------------------------


def _smooth_prim(c):
    """The smooth state of tests/test_baseline_configs.py:201-211."""
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
    p = 1.0 + 0.1 * np.cos(np.pi * c[:, 0])
    vx = 0.5 + 0.1 * np.sin(np.pi * c[:, 1])
    vy = 0.05 * np.cos(2 * np.pi * c[:, 0])
    return np.stack([rho, p, vx, vy, np.zeros_like(vx)], axis=1)


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
def test_implicit_step_matches_jax(banded):
    m, jm = structured_tri_rect(10, 10), j_tri_rect(10, 10)
    td = m.device_arrays(F64, device="cpu", banded_gather=banded)
    jd = jm.device_arrays(banded_gather=banded)
    prim = _smooth_prim(m.cell_centers)
    n = np.tile([1.0, 0.0, 0.0], (m.num_cells, 1))
    u0 = np.array(J.state_from_prim(jnp.asarray(n), jnp.asarray(prim)).make_cons())
    np.testing.assert_allclose(
        _np(T.state_from_prim(torch.as_tensor(n), torch.as_tensor(prim)).make_cons()), u0,
        rtol=1e-15, atol=0)
    dt = 2e-3
    ts = T.FvSolver(td, order=2, bcs={1: T.slip_bc})
    js = J.FvSolver(jd, order=2, bcs={1: J.slip_bc})
    res = ts.implicit_step(torch.as_tensor(u0), dt)
    jres = js.implicit_step(jnp.asarray(u0), dt)
    assert res.converged and bool(jres.converged)
    assert res.num_iterations == int(jres.num_iterations)
    k = res.num_iterations + 1
    h, jh = _np(res.history)[:k], np.asarray(jres.history)[:k]
    assert np.abs(h - jh).max() <= 1e-8 * jh[0]
    # The JAX gate: the true residual of the implicit equation.
    u1 = res.x
    F = _np(u1 + dt * ts.calc_func(u1)) - u0
    assert np.linalg.norm(F) <= 1e-9 * np.linalg.norm(u0)
    assert_close(u1, jres.x, 1e-8)


# -- Laplace2D -------------------------------------------------------------------------

GOLDEN = {100: 0.0069143, 150: 0.00994008, 200: 0.0121789}


@pytest.mark.parametrize("n", sorted(GOLDEN))
def test_laplace2d_golden_and_parity(n):
    u, err = laplace2d(n, 1000, **CPU)
    ju, jerr = j_laplace2d(n, 1000)
    assert float(err) == pytest.approx(GOLDEN[n], abs=1e-4)
    assert abs(float(err) - float(jerr)) <= 1e-12 * float(jerr)
    assert np.abs(_np(u) - np.asarray(ju)).max() <= 1e-12


def test_laplace2d_small_cases():
    assert laplace2d_error(8, 0, **CPU) == 0.0
    u0, _ = laplace2d(8, 0, **CPU)
    u1, err = laplace2d(8, 1, **CPU)
    ju1, jerr = j_laplace2d(8, 1)
    np.testing.assert_allclose(_np(u1), np.asarray(ju1), rtol=0, atol=1e-15)
    assert float(err) == pytest.approx(float(jerr), rel=1e-14)
    # A sweep leaves its input as it was and keeps the boundary.
    np.testing.assert_array_equal(_np(u0)[:, [0, -1]], _np(u1)[:, [0, -1]])
    assert float(laplace2d(8, 3, torch.float32, **CPU)[1]) > 0.0


# -- the projection step -------------------------------------------------------------

NS_OPTS = dict(num_iterations=800, absolute_tolerance=1e-11, relative_tolerance=1e-11)


def _taylor_green(xy):
    """tests/test_navier_stokes.py:18-33: the Taylor–Green field plus a
    removable gradient pollution."""
    x, y = xy[:, 0], xy[:, 1]
    u = np.sin(np.pi * x) * np.cos(np.pi * y)
    v = -np.cos(np.pi * x) * np.sin(np.pi * y)
    gx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    gy = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return np.stack([u + gx, v + gy], axis=1)


def _ns_pair(banded):
    m = j_tri_rect(12, 12)
    tm = build_mesh(m.node_positions, m.cell_nodes)
    ns = NsProjection(tm, nu=1e-2, method="cg", solver_kw={"options": SolverOptions(**NS_OPTS)},
                      banded_gather=banded, dtype=F64, **CPU)
    jns = JNs(m, nu=1e-2, method="cg", solver_kw={"options": JOptions(**NS_OPTS)},
              banded_gather=banded)
    return ns, jns, _taylor_green(m.cell_centers)


def _close(got, want, rel, rows=None):
    got, want = _np(got), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
def test_ns_predictor_matches_jax(banded):
    """u* within 1e-12 on the well-posed cells: the 12×12 mesh's two corner
    cells have singular LSQ systems, whose gradients carry rounding no two
    summation orders agree on (``tests/test_torch_fvm.py::lsq_conditioning``;
    measured 3e-7 in u* there)."""
    from tests.test_torch_fvm import lsq_conditioning

    ns, jns, vel0 = _ns_pair(banded)
    _, good, _ = lsq_conditioning(jns.dmesh)
    assert (~good).sum() == 2
    v_star = ns.predictor(torch.as_tensor(vel0), 1e-2)
    _close(v_star, jns.predictor(jnp.asarray(vel0), 1e-2), 1e-12, good)
    assert bool(torch.isfinite(v_star).all())


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
def test_ns_projection_step_matches_jax(banded):
    """The step from the same u* (the JAX predictor's, for the reason of
    ``test_ns_predictor_matches_jax``): p and the face fluxes within 1e-9 of
    the JAX step's, the velocity within 1e-9 on the well-posed cells; then
    the JAX package's gates on the port's own step."""
    from tests.test_torch_fvm import lsq_conditioning

    ns, jns, vel0 = _ns_pair(banded)
    _, good, _ = lsq_conditioning(jns.dmesh)
    v_star = torch.as_tensor(np.array(jns.predictor(jnp.asarray(vel0), 1e-2)))
    own_predictor = ns.predictor
    ns.predictor = lambda vel, dt: v_star
    vel1, p, res, flux1 = ns.step(torch.as_tensor(vel0), 1e-2)
    jvel1, jp, jres, jflux1 = jns.step(jnp.asarray(vel0), 1e-2)
    assert res.converged and bool(jres.converged)
    assert abs(res.num_iterations - int(jres.num_iterations)) <= 1
    _close(p, jp, 1e-9)
    _close(flux1, jflux1, 1e-9)
    _close(vel1, jvel1, 1e-9, good)
    d0 = np.abs(_np(cell_divergence(ns.dmesh, torch.as_tensor(vel0))))
    np.testing.assert_allclose(
        d0, np.abs(np.asarray(j_cell_divergence(jns.dmesh, jnp.asarray(vel0)))), rtol=0,
        atol=1e-12 * d0.max())
    np.testing.assert_allclose(_np(flux_divergence(ns.dmesh, flux1)),
                               np.asarray(j_flux_divergence(jns.dmesh, jflux1)), rtol=0,
                               atol=1e-9 * d0.max())
    # The JAX package's gates (tests/test_navier_stokes.py) on the port's
    # own step: the corrected face fluxes are divergence-free up to the
    # O(h²) Neumann constant, and the cell divergence falls.
    ns.predictor = own_predictor
    vel1, p, res, flux1 = ns.step(torch.as_tensor(vel0), 1e-2)
    assert res.converged
    df = _np(flux_divergence(ns.dmesh, flux1))
    assert np.abs(df - df.mean()).max() < 1e-7 * d0.max()
    assert np.abs(df.mean()) < 0.01 * d0.max()
    assert np.median(np.abs(_np(cell_divergence(ns.dmesh, vel1)))) < 0.8 * np.median(d0)


def test_ns_partitioned_waits_for_the_distributed_slices():
    """The partitioned pressure solve (``num_parts > 1``) needs this rank's
    handle: without a process group it raises, on two thread ranks it runs
    (``tests/test_torch_parallel_ns.py`` holds its values)."""
    from stormx_torch.core.exceptions import StormError
    from stormx_torch.parallel.comm import run_thread_ranks

    mesh = structured_tri_rect(3, 3)
    with pytest.raises(StormError, match="process group"):
        NsProjection(mesh, num_parts=2, **CPU)
    vel = torch.as_tensor(_taylor_green(mesh.cell_centers))
    out = run_thread_ranks(2, lambda m: NsProjection(
        mesh, num_parts=2, method="cg", dtype=F64, device_mesh=m, **CPU).step(vel, 1e-2),
        device="cpu", timeout=30)
    assert out[0][2].converged and torch.equal(out[0][1], out[1][1])
