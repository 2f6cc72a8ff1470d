"""The port's FVM schemes (``stormx_torch.fvm``) held against the JAX
package's on the same seeded NumPy inputs, in float64 on the CPU.

Tolerances: the pointwise physics (hydro, fluxes, boundary conditions, the
scalar limiters) within 1e-13 of the JAX values, relative to the largest;
the mesh operators (LSQ matrices and gradients, ``compute_limiters``, the
two convection schemes, the convection–diffusion operator) within 1e-12,
relative to the largest: torch and XLA sum the einsums and matrix inverses in
other orders.  Both packages run with K3's plans (the port's plain version of
K3 against the JAX plans in interpret mode) and without them; the port's two
runs are bit-identical, since a gather only selects."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.fvm as J
from stormx.fvm.convdiff import (
    assemble_convection_diffusion as j_assemble_cd,
    convection_diffusion_operator as j_cd_operator,
    face_normal_velocity as j_face_normal_velocity,
)
from stormx.fvm.flux import hllc_flux as j_hllc_flux
from stormx.mesh import build_hybrid_mesh as j_build_hybrid_mesh
from stormx.mesh import build_mesh as j_build_mesh
from stormx.mesh import shapes as j_shapes
from stormx.mesh import structured_tet_box as j_tet_box
from stormx.mesh import structured_tri_rect as j_tri_rect
import stormx_torch.fvm as T
from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.convdiff import scalar_upwind_flux, zero_farfield_bc
from stormx_torch.fvm.gradient import gather_adjacent
from stormx_torch.mesh import build_hybrid_mesh, build_mesh

F64 = torch.float64
POINTWISE = 1e-13
MESH_OPS = 1e-12


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


def _hybrid_groups():
    xs = np.linspace(0, 2, 7)
    ys = np.linspace(0, 1, 4)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    quads, tris = [], []
    for i in range(6):
        for j in range(3):
            a, b, c, d = i * 4 + j, (i + 1) * 4 + j, (i + 1) * 4 + j + 1, i * 4 + j + 1
            if i < 3:
                quads.append([a, b, c, d])
            else:
                tris += [[a, b, c], [a, c, d]]
    return nodes, [(np.asarray(quads), j_shapes.QUADRANGLE), (np.asarray(tris), j_shapes.TRIANGLE)]


def _two_labels(mesh):
    """Boundary faces on x = 0 get label 2 (slip), the others label 1."""
    b = mesh.boundary_faces()
    return {tuple(sorted(int(v) for v in mesh.face_nodes[f] if v >= 0)):
            (2 if mesh.face_centers[f, 0] < 1e-12 else 1) for f in b}


def _mesh_pair(kind):
    """(port mesh, JAX mesh) from the same inputs, boundary labels 1 and 2."""
    if kind == "tri":
        base = j_tri_rect(7, 6)
        labels = _two_labels(base)
        return (build_mesh(base.node_positions, base.cell_nodes, boundary_face_labels=labels),
                j_build_mesh(base.node_positions, base.cell_nodes, boundary_face_labels=labels))
    if kind == "hybrid":
        nodes, groups = _hybrid_groups()
        labels = _two_labels(j_build_hybrid_mesh(nodes, groups))
        return (build_hybrid_mesh(nodes, groups, boundary_face_labels=labels),
                j_build_hybrid_mesh(nodes, groups, boundary_face_labels=labels))
    base = j_tet_box(2, 2, 2)
    labels = _two_labels(base)
    return (build_mesh(base.node_positions, base.cell_nodes, boundary_face_labels=labels),
            j_build_mesh(base.node_positions, base.cell_nodes, boundary_face_labels=labels))


MESH_KINDS = ["tri", "hybrid", "tet"]
_CACHE = {}


def device_meshes(kind, banded):
    """(port DeviceMesh, JAX DeviceMesh), with or without K3's plans."""
    key = (kind, banded)
    if key not in _CACHE:
        tm, jm = _mesh_pair(kind)
        assert tm.num_labels == jm.num_labels == 3
        _CACHE[key] = (tm.device_arrays(F64, device="cpu", banded_gather=banded),
                       jm.device_arrays(banded_gather=banded))
    return _CACHE[key]


def random_prim(rng, shape):
    """Valid primitive states: ρ, p in [0.2, 2.2], |v| up to ~2 (some faces
    supersonic)."""
    prim = np.empty(shape + (5,))
    prim[..., 0] = 0.2 + 2.0 * rng.random(shape)
    prim[..., 1] = 0.2 + 2.0 * rng.random(shape)
    prim[..., 2:] = 2.0 * rng.standard_normal(shape + (3,)) / np.sqrt(3.0)
    return prim


def random_normals(rng, m, dim):
    n = rng.standard_normal((m, dim))
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def random_cons(rng, m, dim):
    n = random_normals(rng, m, dim)
    prim = random_prim(rng, (m,))
    if dim == 2:
        prim[:, 4] = 0.0
    return n, np.array(J.state_from_prim(jnp.asarray(n), jnp.asarray(prim)).make_cons())


def euler_state(rng, dm_j):
    """A conserved state near the Euler app's uniform one, perturbed."""
    from stormx.apps.euler import initial_state

    u0 = np.array(initial_state(dm_j.num_cells))
    return u0 * (1.0 + 0.05 * rng.random(u0.shape))


# -- field ----------------------------------------------------------------------


@pytest.mark.parametrize("fn,count", [("cell_field", "num_cells"), ("face_field", "num_faces"),
                                      ("node_field", "num_nodes")])
def test_fields(fn, count):
    tm, jm = _mesh_pair("tri")
    n = getattr(tm, count)
    got = getattr(T, fn)(tm, 3, fill=2.5, dtype=F64, device="cpu")
    want = getattr(J, fn)(jm, 3, fill=2.5)
    assert got.shape == (n, 3) and got.dtype == F64
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert getattr(T, fn)(tm, device="cpu").shape == (n,)
    assert getattr(T, fn)(tm, device="cpu").dtype == torch.float32


def test_field_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    tm, _ = _mesh_pair("tri")
    with pytest.raises(StormError, match="CUDA"):
        T.cell_field(tm)


# -- hydro, fluxes, boundary conditions ------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_hydro_states(dim, rng):
    n = random_normals(rng, 200, dim)
    prim = random_prim(rng, (200,))
    sj = J.state_from_prim(jnp.asarray(n), jnp.asarray(prim))
    st = T.state_from_prim(torch.as_tensor(n), torch.as_tensor(prim))
    for a, b in zip(st, sj):
        assert_close(a, b, POINTWISE)
    cons = _np(st.make_cons())
    assert_close(cons, sj.make_cons(), POINTWISE)
    n3 = np.concatenate([n, np.zeros((200, 3 - dim))], axis=1)
    assert_close(st.make_flux(torch.as_tensor(n3)), sj.make_flux(jnp.asarray(n3)), POINTWISE)
    back_j = J.state_from_cons(jnp.asarray(n), jnp.asarray(cons))
    back_t = T.state_from_cons(torch.as_tensor(n), torch.as_tensor(cons))
    for a, b in zip(back_t, back_j):
        assert_close(a, b, POINTWISE)
    assert_close(back_t.p, prim[:, 1], 1e-13)


FLUXES = [("lax_friedrichs", J.lax_friedrichs_flux, T.lax_friedrichs_flux),
          ("hll", J.hll_flux, T.hll_flux),
          ("hllc", j_hllc_flux, T.hllc_flux)]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name,jf,tf", FLUXES, ids=[f[0] for f in FLUXES])
def test_fluxes(name, jf, tf, dim, rng):
    n, cons_r = random_cons(rng, 300, dim)
    _, cons_l = random_cons(rng, 300, dim)
    cons_l[:50] = cons_r[:50]  # consistency: F(U, U)
    want = jf(jnp.asarray(n), jnp.asarray(cons_r), jnp.asarray(cons_l))
    got = tf(torch.as_tensor(n), torch.as_tensor(cons_r), torch.as_tensor(cons_l))
    assert_close(got, want, POINTWISE)


def test_hllc_keeps_a_stationary_contact():
    n = torch.tensor([[1.0, 0.0]], dtype=F64)
    cons = [T.state_from_prim(n, torch.tensor([[rho, 1.0, 0.0, 0.0, 0.0]], dtype=F64)).make_cons()
            for rho in (0.125, 1.0)]
    assert abs(float(T.hllc_flux(n, cons[0], cons[1])[0, 0])) < 1e-12
    assert abs(float(T.lax_friedrichs_flux(n, cons[0], cons[1])[0, 0])) > 1e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_boundary_conditions(dim, rng):
    n, cons = random_cons(rng, 150, dim)
    r = rng.random((150, dim))
    nt, ct, rt = torch.as_tensor(n), torch.as_tensor(cons), torch.as_tensor(r)
    nj, cj, rj = jnp.asarray(n), jnp.asarray(cons), jnp.asarray(r)
    assert T.far_field_bc(nt, rt, ct) is ct
    assert_close(T.slip_bc(nt, rt, ct), J.slip_bc(nj, rj, cj), POINTWISE)
    assert_close(T.no_slip_bc(nt, rt, ct), J.no_slip_bc(nj, rj, cj), POINTWISE)

    vel_t = lambda pos: torch.cat([torch.zeros_like(pos[:, :1]), pos[:, :1],  # noqa: E731
                                   torch.zeros_like(pos[:, :1])], dim=1)
    vel_j = lambda pos: jnp.concatenate([jnp.zeros_like(pos[:, :1]), pos[:, :1],  # noqa: E731
                                         jnp.zeros_like(pos[:, :1])], axis=1)
    assert_close(T.no_slip_bc(nt, rt, ct, vel_fn=vel_t), J.no_slip_bc(nj, rj, cj, vel_fn=vel_j),
                 POINTWISE)
    # The input states are left as they were.
    np.testing.assert_array_equal(_np(ct), cons)


# -- gradients and limiters -------------------------------------------------------


def lsq_conditioning(jd):
    """Per cell, cond of its regularized LSQ matrix (from the JAX inverse)
    and whether it and every face neighbour are well posed (cond < 1e6).

    A corner cell with fewer than ``dim`` independent neighbours has a
    singular Σ dr⊗dr: after the regularization its cond is ≈ 1/(100·ε)
    (4e11-4e12 here), and the gradient's component along the missing
    direction is rounding amplified by that cond; LU on such a matrix is
    accurate to cond·ε only, in every direction, so no two summation orders
    agree on those cells' gradients (measured: 2e-4 of the largest on the
    triangle rectangle's two corner cells).  The parity tests hold gradients
    at 1e-12 on the well-posed cells, and the 2nd-order convection at 1e-12
    on the cells whose stencil holds no other."""
    cond = np.linalg.cond(np.linalg.inv(np.asarray(J.lsq_gradient_matrices(jd))))
    good = cond < 1e6
    stencil = good & good[np.asarray(jd.cell_adj_ell)].all(axis=1)
    return cond, good, stencil


@pytest.mark.parametrize("kind", MESH_KINDS)
def test_lsq_gradient_matrices(kind):
    """Cell by cell within 1e-12·cond of the cell's matrix, relative to its
    largest entry: both packages invert by LU in their own orders."""
    td, jd = device_meshes(kind, False)
    got, want = _np(T.lsq_gradient_matrices(td)), np.asarray(J.lsq_gradient_matrices(jd))
    cond, good, _ = lsq_conditioning(jd)
    assert good.sum() >= 0.7 * len(good) and (cond[good] < 1e3).all()
    err = np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    assert (err <= MESH_OPS * np.maximum(cond, 1.0)).all(), (err / cond).max()
    assert (err[good] <= MESH_OPS).all()


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
@pytest.mark.parametrize("kind", MESH_KINDS)
def test_lsq_gradients(kind, banded, rng):
    """Within 1e-12 on the well-posed cells (``lsq_conditioning``) and
    finite on the others; the port's runs with and without plans are
    bit-identical."""
    td, jd = device_meshes(kind, banded)
    _, good, _ = lsq_conditioning(jd)
    for shape in ((td.num_cells,), (td.num_cells, 4)):
        u = rng.standard_normal(shape)
        got = T.lsq_gradients(td, torch.as_tensor(u))
        want = np.asarray(J.lsq_gradients(jd, jnp.asarray(u)))
        assert_close(_np(got)[good], want[good], MESH_OPS)
        assert bool(torch.isfinite(got).all())
        plain = T.lsq_gradients(device_meshes(kind, False)[0], torch.as_tensor(u))
        assert torch.equal(got, plain)


def test_gradient_of_linear_field_is_exact():
    td, _ = device_meshes("tri", False)
    c = td.cell_centers
    u = 3.0 * c[:, 0] - 2.0 * c[:, 1] + 0.5
    g = T.lsq_gradients(td, u)
    interior = torch.as_tensor(np.setdiff1d(np.arange(td.num_cells),
                                            _np(td.face_inner[td.boundary_faces])))
    assert_close(g[interior], np.tile([3.0, -2.0], (len(interior), 1)), 1e-10)


LIMITERS = ["minmod_limiter", "venkatakrishnan_limiter", "cubic_limiter"]
SECOND = ["dummy_second_limiter", "cubic_second_limiter"]


@pytest.mark.parametrize("name", LIMITERS)
def test_slope_limiters(name, rng):
    du_min = -np.abs(rng.standard_normal(500))
    du_max = np.abs(rng.standard_normal(500))
    du_face = rng.standard_normal(500)
    du_face[::7] = 0.0
    eps_sqr = 1e-3 * rng.random(500)
    args = (du_min, du_max, du_face, eps_sqr)
    got = getattr(T, name)(*map(torch.as_tensor, args))
    want = getattr(J, name)(*map(jnp.asarray, args))
    assert_close(got, want, POINTWISE)
    assert bool((got[::7] == 1.0).all())


@pytest.mark.parametrize("name", SECOND)
def test_second_limiters(name, rng):
    lim = rng.random(500)
    du_min = -np.abs(rng.standard_normal(500)) * 0.1
    du_max = np.abs(rng.standard_normal(500)) * 0.1
    eps_sqr = 0.01 * rng.random(500)  # every branch: ≤ ε², ≥ 2ε² and between
    args = (lim, du_min, du_max, eps_sqr)
    assert_close(getattr(T, name)(*map(torch.as_tensor, args)),
                 getattr(J, name)(*map(jnp.asarray, args)), POINTWISE)


def test_limiters_stay_in_float32():
    x = torch.linspace(-1, 1, 11, dtype=torch.float32)
    for name in LIMITERS:
        assert getattr(T, name)(x - 1, x + 1, x, x.abs()).dtype == torch.float32
    assert T.cubic_second_limiter(x, x - 1, x + 1, x.abs() + 1).dtype == torch.float32


@pytest.mark.parametrize("second", SECOND)
@pytest.mark.parametrize("slope", LIMITERS)
@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
def test_compute_limiters(banded, slope, second, rng):
    td, jd = device_meshes("tri", banded)
    u = euler_state(rng, jd)
    g = J.lsq_gradients(jd, jnp.asarray(u))
    kw_j = dict(slope_limiter=getattr(J, slope), second_limiter=getattr(J, second))
    kw_t = dict(slope_limiter=getattr(T, slope), second_limiter=getattr(T, second))
    got = T.compute_limiters(td, torch.as_tensor(u), torch.as_tensor(np.array(g)), **kw_t)
    assert_close(got, J.compute_limiters(jd, jnp.asarray(u), g, **kw_j), MESH_OPS)
    # a scalar field
    got_s = T.compute_limiters(td, torch.as_tensor(u[:, 0]),
                               torch.as_tensor(np.array(g)[:, 0]), **kw_t)
    assert got_s.shape == (td.num_cells,)
    assert_close(got_s, J.compute_limiters(jd, jnp.asarray(u[:, 0]), g[:, 0], **kw_j), MESH_OPS)
    plain = T.compute_limiters(device_meshes("tri", False)[0], torch.as_tensor(u),
                               torch.as_tensor(np.array(g)), **kw_t)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kind", MESH_KINDS)
def test_compute_limiters_other_meshes(kind, rng):
    td, jd = device_meshes(kind, True)
    u = euler_state(rng, jd)
    g = J.lsq_gradients(jd, jnp.asarray(u))
    assert_close(T.compute_limiters(td, torch.as_tensor(u), torch.as_tensor(np.array(g))),
                 J.compute_limiters(jd, jnp.asarray(u), g), MESH_OPS)


def test_gather_adjacent_with_plans_matches_indexing(rng):
    td, _ = device_meshes("hybrid", True)
    v = torch.as_tensor(rng.standard_normal((td.num_cells, 3)))
    got = gather_adjacent(td, v)
    assert got.shape == td.cell_adj_ell.shape + (3,)
    assert torch.equal(got, v[td.cell_adj_ell])


# -- convection ---------------------------------------------------------------------


def _bcs(pkg):
    return {1: pkg.far_field_bc, 2: pkg.slip_bc}


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("banded", [False, True], ids=["plain", "plans"])
@pytest.mark.parametrize("kind", MESH_KINDS)
def test_convection_two_labels(kind, banded, order, rng):
    td, jd = device_meshes(kind, banded)
    u = euler_state(rng, jd)
    fn_t = T.upwind_convection if order == 1 else T.linear_upwind_convection
    fn_j = J.upwind_convection if order == 1 else J.linear_upwind_convection
    ut = torch.as_tensor(u)
    got = fn_t(td, ut, _bcs(T))
    want = np.asarray(fn_j(jd, jnp.asarray(u), _bcs(J)))
    if order == 1:
        assert_close(got, want, MESH_OPS)
    else:
        # On the 3-D box 12 of 48 cells have singular LSQ systems
        # (``lsq_conditioning``): the cells whose stencil holds none are held
        # at 1e-12, the others carry those cells' rounding (measured 4.1e-6).
        _, _, stencil = lsq_conditioning(jd)
        assert stencil.sum() > 0
        assert_close(_np(got)[stencil], want[stencil], MESH_OPS)
        assert_close(got, want, MESH_OPS if stencil.all() else 1e-5)
    np.testing.assert_array_equal(_np(ut), u)  # the state is left as it was
    plain = fn_t(device_meshes(kind, False)[0], ut, _bcs(T))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("scheme", ["hll_flux", "hllc_flux"])
def test_linear_convection_other_fluxes(scheme, rng):
    td, jd = device_meshes("tri", True)
    u = euler_state(rng, jd)
    jf = J.hll_flux if scheme == "hll_flux" else j_hllc_flux
    assert_close(T.linear_upwind_convection(td, torch.as_tensor(u), _bcs(T), getattr(T, scheme)),
                 J.linear_upwind_convection(jd, jnp.asarray(u), _bcs(J), jf), MESH_OPS)


@pytest.mark.parametrize("order", [1, 2])
def test_uniform_state_has_zero_divergence(order):
    td, _ = device_meshes("tet", False)
    from stormx_torch.apps.euler import initial_state

    u = initial_state(td.num_cells, prim=(1.0, 1.0, 0.0, 0.0, 0.0), dtype=F64, device="cpu")
    fn = T.upwind_convection if order == 1 else T.linear_upwind_convection
    assert float(fn(td, u, {1: T.far_field_bc, 2: T.far_field_bc}).abs().max()) < 1e-12


def test_missing_boundary_label_raises():
    td, _ = device_meshes("tri", False)
    from stormx_torch.apps.euler import initial_state

    u = initial_state(td.num_cells, dtype=F64, device="cpu")
    with pytest.raises(StormError, match=r"\[2\]"):
        T.upwind_convection(td, u, {1: T.far_field_bc})
    with pytest.raises(StormError):
        T.linear_upwind_convection(td, u, {2: T.slip_bc})


# -- convection-diffusion -------------------------------------------------------------


def _rotating(r):
    return np.stack([-(r[:, 1] - 0.5), r[:, 0] - 0.5], axis=1)


@pytest.mark.parametrize("velocity", ["rotating", "constant"])
def test_convection_diffusion(velocity, rng):
    tm, jm = _mesh_pair("tri")
    vel = _rotating if velocity == "rotating" else np.array([0.7, -0.3])
    eps = 0.05
    vn_t = T.face_normal_velocity(tm, vel)
    vn_j = j_face_normal_velocity(jm, vel)
    np.testing.assert_array_equal(vn_t, vn_j)
    ell = T.assemble_convection_diffusion(tm, vel, eps)
    ell_j = j_assemble_cd(jm, vel, eps)
    np.testing.assert_array_equal(_np(ell.cols), np.asarray(ell_j.cols))
    assert_close(ell.data, ell_j.data, POINTWISE)
    u = rng.standard_normal(tm.num_cells)
    want = np.asarray(j_cd_operator(jm.device_arrays(), vn_j, eps)(jnp.asarray(u)))
    for banded in (False, True):
        op = T.convection_diffusion_operator(
            tm.device_arrays(F64, device="cpu", banded_gather=banded), vn_t, eps)
        assert_close(op(torch.as_tensor(u)), want, MESH_OPS)
    assert_close(ell.matvec(torch.as_tensor(u)), want, MESH_OPS)


def test_scalar_upwind_pieces():
    vn = torch.tensor([1.0, -2.0, 0.0], dtype=F64)
    u_out = torch.tensor([[10.0], [20.0], [30.0]], dtype=F64)
    u_in = torch.tensor([[1.0], [2.0], [3.0]], dtype=F64)
    got = scalar_upwind_flux(vn)(None, u_out, u_in)
    np.testing.assert_array_equal(_np(got)[:, 0], [1.0, -40.0, 0.0])
    assert torch.equal(zero_farfield_bc(None, None, u_in), torch.zeros_like(u_in))
