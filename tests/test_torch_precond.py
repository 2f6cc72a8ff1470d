"""The preconditioners of stormx_torch against the JAX package's, in float64
on the same numpy-made inputs.

* Host builds are the same NumPy (or the same native routine) on both
  sides, so they are held bit-exact: ``aggregate`` and ``_coarsen``, the AMG
  levels, ``TriangularFactor``'s arrays and ``num_levels``, the ILU(0) and
  IC(0) factor values (native and pure Python), ``spai0_build``'s and
  ``ainv_build``'s CSR triples and ``normal_equations_csr``.
* Applies and adjoint applies agree to 1e-12 relative (torch and XLA sum
  rows and gathers in other orders).
* Solver histories agree to 1e-10 relative with equal iteration counts, each
  entry also allowed 1e-13 of the initial residual (``tests/
  test_torch_krylov.py`` says why).

The operators: the 16×16 Dirichlet Poisson operator of
``tests/test_precond.py`` (SPD), the pure-Neumann two-point-flux Laplacian
of a ``structured_tri_rect`` mesh (singular; AMG and Chebyshev take it), and
BASELINE config #2's convection–diffusion operator on a small mesh
(nonsymmetric; ILU(0) and SPAI(0) under FGMRES).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx import precond as jp
from stormx import solvers as js
from stormx.precond import approx_inverse as jai
from stormx.precond import factorized as jfac
from stormx.precond import iqr as jiqr
from stormx.precond import multigrid as jmg
from stormx.sparse import formats as jf
from stormx_torch import precond as tp
from stormx_torch import solvers as ts
from stormx_torch._native import native_ic0, native_ilu0
from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.convdiff import assemble_convection_diffusion
from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.precond import approx_inverse as tai
from stormx_torch.precond import factorized as tfac
from stormx_torch.precond import iqr as tiqr
from stormx_torch.precond import multigrid as tmg
from stormx_torch.sparse import formats as tf

CPU = dict(device="cpu")
TIGHT = dict(num_iterations=600, absolute_tolerance=0.0, relative_tolerance=1e-10)


def _triples_from_dense(a):
    rows, cols = np.nonzero(a)
    rp = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return np.cumsum(rp), cols.astype(np.int64), a[rows, cols]


def _poisson(nx):
    """The Dirichlet 5-point operator of ``tests/test_precond.py:27-50``."""
    n = nx * nx
    a = 4.0 * np.eye(n)
    for k in range(n):
        i, j = divmod(k, nx)
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            if 0 <= i + di < nx and 0 <= j + dj < nx:
                a[k, (i + di) * nx + j + dj] = -1.0
    return _triples_from_dense(a), (n, n)


def _rect_laplacian():
    csr = assemble_laplacian(structured_tri_rect(12, 10)).to_csr()
    return (tf.host(csr.row_ptr).astype(np.int64), tf.host(csr.indices).astype(np.int64),
            tf.host(csr.data)), csr.shape


def _convdiff():
    mesh = structured_tri_rect(10, 9)
    ell = assemble_convection_diffusion(
        mesh, lambda r: np.stack([-(r[:, 1] - 0.5), r[:, 0] - 0.5], axis=1), 0.05)
    csr = ell.to_csr()
    return (tf.host(csr.row_ptr).astype(np.int64), tf.host(csr.indices).astype(np.int64),
            tf.host(csr.data)), csr.shape


OPERATORS = {"poisson16": lambda: _poisson(16), "rect": _rect_laplacian,
             "convdiff": _convdiff}


def _pair(name):
    """(port CSR on the CPU, JAX CSR, dense) of one operator."""
    (rp, cols, vals), shape = OPERATORS[name]()
    t = tf.CSR(data=torch.as_tensor(vals), indices=torch.as_tensor(cols.astype(np.int32)),
               row_ptr=torch.as_tensor(rp.astype(np.int32)), shape=shape)
    j = jf.CSR(data=jnp.asarray(vals), indices=jnp.asarray(cols.astype(np.int32)),
               row_ptr=jnp.asarray(rp.astype(np.int32)), shape=shape)
    dense = np.zeros(shape)
    np.add.at(dense, (np.repeat(np.arange(shape[0]), np.diff(rp)), cols), vals)
    return t, j, dense


def _rhs(n, seed=3, mean_free=False):
    b = np.random.default_rng(seed).standard_normal(n)
    return b - b.mean() if mean_free else b


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _same_history(t, j):
    assert t.converged == bool(j.converged)
    assert t.num_iterations == int(j.num_iterations)
    k = t.num_iterations
    hj = np.asarray(j.history)[: k + 1]
    np.testing.assert_allclose(t.history.numpy()[: k + 1], hj, rtol=1e-10, atol=1e-13 * hj[0])


def _solve_both(method, tcsr, jcsr, tpre, jpre, b, **opts):
    options = dict(TIGHT, **opts)
    t = ts.SOLVERS[method](ts.make_operator(tcsr.matvec), torch.as_tensor(b),
                           torch.zeros(len(b), dtype=torch.float64), precond=tpre,
                           options=ts.SolverOptions(**options))
    j = js.SOLVERS[method](js.make_operator(jcsr.matvec), jnp.asarray(b), jnp.zeros(len(b)),
                           precond=jpre, options=js.SolverOptions(**options))
    return t, j


# -- the protocol -------------------------------------------------------------


def test_protocol_conj_apply_raises_where_jax_raises():
    x = torch.ones(3, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        ts.Preconditioner().conj_apply(x)
    assert torch.equal(ts.IdentityPreconditioner().conj_apply(x), x)
    blocks = torch.eye(2, dtype=torch.float64).repeat(3, 1, 1) * 2.0
    with pytest.raises(NotImplementedError):  # the JAX block-Jacobi has none
        tp.BlockJacobiPreconditioner(blocks=blocks).conj_apply(torch.ones(6, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        tp.KrylovPreconditioner(method="cg").conj_apply(x)


def test_jacobi_conj_apply_matches_jax():
    d = np.random.default_rng(0).standard_normal(20) + 3.0
    r = np.random.default_rng(1).standard_normal(20)
    got = tp.JacobiPreconditioner(diag=torch.as_tensor(d)).conj_apply(torch.as_tensor(r))
    want = jp.JacobiPreconditioner(diag=jnp.asarray(d)).conj_apply(jnp.asarray(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cls", ["AmgPreconditioner", "SgsPreconditioner",
                                 "IluPreconditioner", "IcPreconditioner",
                                 "SpaiPreconditioner", "AinvPreconditioner",
                                 "IqrPreconditioner"])
def test_csr_preconditioners_default_to_the_card(cls):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken, not refused")
    tcsr, _, _ = _pair("poisson16")
    with pytest.raises(StormError):
        getattr(tp, cls)(tcsr)
    with pytest.raises(StormError):
        tp.build_triangular(np.array([0, 1]), np.array([0]), np.array([2.0]), 1, lower=True)


# -- multigrid ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["poisson16", "rect"])
@pytest.mark.parametrize("theta", [0.25, 0.02])
def test_aggregate_and_coarsen_bit_exact(name, theta):
    (rp, cols, vals), (n, _) = OPERATORS[name]()
    agg = tmg.aggregate(rp, cols, vals, n, theta)
    np.testing.assert_array_equal(agg, jmg.aggregate(rp, cols, vals, n, theta))
    nc = int(agg.max()) + 1
    for got, want in zip(tmg._coarsen(rp, cols, vals, n, agg, nc),
                         jmg._coarsen(rp, cols, vals, n, agg, nc)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,sweeps,coarse", [("poisson16", 1, 16), ("rect", 2, 64),
                                                ("rect", 1, 8)])
def test_amg_levels_bit_exact_and_apply(name, sweeps, coarse):
    tcsr, jcsr, _ = _pair(name)
    t = tp.AmgPreconditioner(tcsr, num_sweeps=sweeps, coarse_size=coarse, **CPU)
    j = jp.AmgPreconditioner(jcsr, num_sweeps=sweeps, coarse_size=coarse)
    assert len(t._levels) == len(j._levels) > 0
    for lt, lj in zip(t._levels, j._levels):
        assert (lt["n"], lt["nc"]) == (lj["n"], lj["nc"])
        for key in ("ell_cols", "ell_vals", "inv_diag", "agg"):
            np.testing.assert_array_equal(lt[key].numpy(), np.asarray(lj[key]))
    np.testing.assert_array_equal(t._coarse_inv.numpy(), np.asarray(j._coarse_inv))
    r = _rhs(tcsr.shape[0])
    _close(t(torch.as_tensor(r)), j(jnp.asarray(r)))
    _close(t.conj_apply(torch.as_tensor(r)), j.conj_apply(jnp.asarray(r)))


@pytest.mark.parametrize("sweeps", [1, 2])
def test_amg_fine_matvec_routing(sweeps):
    """``fine_matvec`` equal to the level-0 ELL product gives the same
    V-cycle (``tests/test_precond.py:632-655``), and is called
    2·num_sweeps + 1 times per apply."""
    tcsr, _, _ = _pair("rect")
    base = tp.AmgPreconditioner(tcsr, num_sweeps=sweeps, **CPU)
    lvl0 = base._levels[0]
    calls = [0]

    def mv(x):
        calls[0] += 1
        return (lvl0["ell_vals"] * x[lvl0["ell_cols"]]).sum(dim=1)

    routed = tp.AmgPreconditioner(tcsr, num_sweeps=sweeps, fine_matvec=mv, **CPU)
    r = torch.as_tensor(_rhs(tcsr.shape[0]))
    np.testing.assert_array_equal(base(r).numpy(), routed(r).numpy())
    assert calls[0] == 2 * sweeps + 1


def test_amg_levels_follow_the_requested_dtype():
    tcsr, _, _ = _pair("rect")
    amg = tp.AmgPreconditioner(tcsr, dtype=torch.float32, **CPU)
    r = torch.as_tensor(_rhs(tcsr.shape[0]), dtype=torch.float32)
    assert amg(r).dtype == torch.float32
    assert amg._coarse_inv.dtype == torch.float32
    assert all(lvl["ell_vals"].dtype == torch.float32 for lvl in amg._levels)


# -- Chebyshev -------------------------------------------------------------------


@pytest.mark.parametrize("degree,lmax", [(4, None), (3, 9.0), (0, None)])
def test_chebyshev_apply_matches_jax(degree, lmax):
    tcsr, jcsr, _ = _pair("poisson16")
    b = _rhs(tcsr.shape[0])
    calls = [0]

    def counted(x):
        calls[0] += 1
        return tcsr.matvec(x)

    t = tp.ChebyshevPreconditioner(degree, lambda_max=lmax).build(
        None, torch.as_tensor(b), counted)
    j = jp.ChebyshevPreconditioner(degree, lambda_max=lmax).build(
        None, jnp.asarray(b), jcsr.matvec)
    assert calls[0] == (10 if lmax is None else 0)
    _close(torch.as_tensor(t._lmax), float(j._lmax), 1e-13)
    calls[0] = 0
    got = t(torch.as_tensor(b))
    assert calls[0] == degree
    _close(got, j(jnp.asarray(b)))
    _close(t.conj_apply(torch.as_tensor(b)), j.conj_apply(jnp.asarray(b)))


def test_chebyshev_power_estimate_is_below_lambda_max_in_both():
    """The JAX package's 10 power iterations underestimate λmax even after
    the 1.05 safety factor, so p(A) is negative on the top of the spectrum:
    CG then runs with an indefinite preconditioner, in both packages.  It
    still converges, but roundoff (the two packages sum in other orders)
    grows fast once the residual is small, so the histories part after a
    few dozen iterations.  The port keeps the JAX semantics; what both
    packages give is held here: the same estimate, convergence, iteration
    counts within one, and solutions within 1e-8."""
    tcsr, jcsr, dense = _pair("poisson16")
    b = _rhs(tcsr.shape[0])
    tpre, jpre = tp.ChebyshevPreconditioner(4), jp.ChebyshevPreconditioner(4)
    t, j = _solve_both("cg", tcsr, jcsr, tpre, jpre, b)
    lam = float(tpre._lmax)
    assert abs(lam - float(jpre._lmax)) <= 1e-13 * lam
    assert lam < np.linalg.eigvalsh(dense).max()
    assert t.converged and bool(j.converged)
    assert abs(t.num_iterations - int(j.num_iterations)) <= 1
    x_j = np.asarray(j.x)
    assert np.linalg.norm(t.x.numpy() - x_j) <= 1e-8 * np.linalg.norm(x_j)


# -- triangular solves -----------------------------------------------------------


def _random_triangle(n, lower, seed):
    rng = np.random.default_rng(seed)
    dense = np.tril(rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3))
    np.fill_diagonal(dense, 2.0 + rng.random(n))
    return dense if lower else dense.T


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("sweeps", [None, 3])
def test_triangular_factor_bit_exact_and_solve(lower, sweeps):
    dense = _random_triangle(40, lower, 0)
    rp, cols, vals = _triples_from_dense(dense)
    t = tp.build_triangular(rp, cols.astype(np.int32), vals, 40, lower=lower, **CPU)
    j = jp.build_triangular(rp, cols.astype(np.int32), vals, 40, lower=lower)
    assert t.num_levels == j.num_levels and t.num_rows == j.num_rows
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = _rhs(40)
    got = tp.tri_solve(t, torch.as_tensor(r), sweeps=sweeps)
    _close(got, jp.tri_solve(j, jnp.asarray(r), sweeps=sweeps))
    if sweeps is None:
        np.testing.assert_allclose(dense @ got.numpy(), r, atol=1e-10)


def test_triangular_unit_diagonal_and_rejections():
    dense = _random_triangle(12, True, 1)
    rp, cols, vals = _triples_from_dense(dense)
    t = tp.build_triangular(rp, cols, vals, 12, lower=True, unit_diagonal=True, **CPU)
    j = jp.build_triangular(rp, cols, vals, 12, lower=True, unit_diagonal=True)
    for got, want in zip(t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="wrong side"):
        tp.build_triangular(rp, cols, vals, 12, lower=False, **CPU)


# -- incomplete factorizations ----------------------------------------------------


def _random_spd(n=120, seed=7):
    """``tests/test_precond.py``'s native-factorization matrix."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, n))
    for i in range(n):
        js_ = rng.choice(n, size=rng.integers(2, 7), replace=False)
        dense[i, js_] = rng.standard_normal(len(js_))
    dense = dense + dense.T + np.eye(n) * 10.0
    rp, cols, vals = _triples_from_dense(dense)
    return rp, cols, vals, n


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("unsorted", [False, True])
def test_ilu0_factor_bit_exact(seed, unsorted):
    rp, cols, vals, n = _random_spd(seed=seed)
    if unsorted:
        rng = np.random.default_rng(0)
        order = np.concatenate([rp[i] + rng.permutation(rp[i + 1] - rp[i]) for i in range(n)])
        cols, vals = cols[order], vals[order]
    want = jfac._ilu0_factorize_py(rp, cols, vals, n)
    np.testing.assert_array_equal(tfac._ilu0_factorize_py(rp, cols, vals, n), want)
    native = native_ilu0(rp, cols, vals)
    assert native is not None, "g++ builds the port's host runtime here"
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(tfac.ilu0_factorize(rp, cols, vals, n),
                                  jfac.ilu0_factorize(rp, cols, vals, n))


@pytest.mark.parametrize("seed", [13, 5])
def test_ic0_factor_bit_exact(seed):
    rp, cols, vals, n = _random_spd(seed=seed)
    l_cols, l_vals = tfac.ic0_factorize(rp, cols, vals, n)
    j_cols, j_vals = jfac.ic0_factorize(rp, cols, vals, n)
    assert l_cols == j_cols and l_vals == j_vals
    got, want = tfac.ic0_factorize_csr(rp, cols, vals, n), jfac.ic0_factorize_csr(rp, cols, vals, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The native routine on A's lower triangle (ascending columns) against
    # the JAX package's pure-Python factor.
    rows = np.repeat(np.arange(n), np.diff(rp))
    lower = cols <= rows
    order = np.lexsort((cols[lower], rows[lower]))
    native = native_ic0(got[0], cols[lower][order], vals[lower][order])
    np.testing.assert_array_equal(native, np.concatenate([np.asarray(v) for v in j_vals]))
    np.testing.assert_array_equal(got[2], np.concatenate([np.asarray(v) for v in j_vals]))


def test_factorization_errors_match_jax():
    rp = np.array([0, 1, 2], dtype=np.int64)
    cols = np.array([0, 1], dtype=np.int64)
    with pytest.raises(ValueError, match="non-positive pivot"):
        tfac.ic0_factorize_csr(rp, cols, np.array([1.0, -1.0]), 2)
    with pytest.raises(ValueError, match="non-positive pivot"):
        tfac.ic0_factorize(rp, cols, np.array([1.0, -1.0]), 2)
    with pytest.raises(ValueError, match="explicitly stored diagonal"):
        tfac.ilu0_factorize(np.array([0, 1, 1]), np.array([1]), np.array([1.0]), 2)
    with pytest.raises(ValueError, match="explicitly stored diagonal"):
        tfac._ilu0_factorize_py(np.array([0, 1, 1]), np.array([1]), np.array([1.0]), 2)


FACTORED = [("SgsPreconditioner", "poisson16"), ("IcPreconditioner", "poisson16"),
            ("IluPreconditioner", "convdiff")]


@pytest.mark.parametrize("cls,name", FACTORED)
@pytest.mark.parametrize("sweeps", [None, 3])
def test_factored_apply_matches_jax(cls, name, sweeps):
    tcsr, jcsr, _ = _pair(name)
    t = getattr(tp, cls)(tcsr, sweeps=sweeps, **CPU)
    j = getattr(jp, cls)(jcsr, sweeps=sweeps)
    for ft, fj in ((t._first, j._first), (t._second, j._second)):
        for got, want in zip(ft, fj):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = _rhs(tcsr.shape[0])
    _close(t(torch.as_tensor(r)), j(jnp.asarray(r)))
    _close(t.conj_apply(torch.as_tensor(r)), j.conj_apply(jnp.asarray(r)))


def test_factored_exact_apply_inverts_the_factors():
    tcsr, _, _ = _pair("convdiff")
    z = tp.IluPreconditioner(tcsr, **CPU)(torch.ones(tcsr.shape[0], dtype=torch.float64))
    # ILU(0) of a matrix whose fill-in is dropped is no exact inverse; hold
    # the apply to L·U z = 1 instead, with L and U from the factor values.
    rp, cols, vals = (tf.host(tcsr.row_ptr), tf.host(tcsr.indices), tf.host(tcsr.data))
    lu = tfac.ilu0_factorize(rp, cols, vals, tcsr.shape[0])
    n = tcsr.shape[0]
    full = np.zeros((n, n))
    full[np.repeat(np.arange(n), np.diff(rp)), cols] = lu
    L, U = np.tril(full, -1) + np.eye(n), np.triu(full)
    np.testing.assert_allclose(L @ U @ z.numpy(), np.ones(n), atol=1e-10)


# -- approximate inverses ---------------------------------------------------------


def test_spai0_build_bit_exact_and_apply():
    tcsr, jcsr, _ = _pair("convdiff")
    rp, cols, vals = tf.host(tcsr.row_ptr), tf.host(tcsr.indices), tf.host(tcsr.data)
    for got, want in zip(tai.spai0_build(rp, cols, vals, tcsr.shape[0]),
                         jai.spai0_build(rp, cols, vals, tcsr.shape[0])):
        np.testing.assert_array_equal(got, want)
    t, j = tp.SpaiPreconditioner(tcsr, **CPU), jp.SpaiPreconditioner(jcsr)
    r = _rhs(tcsr.shape[0])
    _close(t(torch.as_tensor(r)), j(jnp.asarray(r)))
    _close(t.conj_apply(torch.as_tensor(r)), j.conj_apply(jnp.asarray(r)))
    np.testing.assert_array_equal(t._mt.row_ptr.numpy(), np.asarray(j._mt.row_ptr))
    np.testing.assert_array_equal(t._mt.indices.numpy(), np.asarray(j._mt.indices))
    np.testing.assert_array_equal(t._mt.data.numpy(), np.asarray(j._mt.data))


@pytest.mark.parametrize("drop_tol", [0.0, 0.05, 0.1])
def test_ainv_build_bit_exact_and_apply(drop_tol):
    tcsr, jcsr, _ = _pair("poisson16")
    rp, cols, vals = tf.host(tcsr.row_ptr), tf.host(tcsr.indices), tf.host(tcsr.data)
    (zt, it), (zj, ij) = (tai.ainv_build(rp, cols, vals, 256, drop_tol),
                          jai.ainv_build(rp, cols, vals, 256, drop_tol))
    for got, want in zip(zt, zj):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(it, ij)
    t = tp.AinvPreconditioner(tcsr, drop_tol=drop_tol, **CPU)
    j = jp.AinvPreconditioner(jcsr, drop_tol=drop_tol)
    r = _rhs(256)
    _close(t(torch.as_tensor(r)), j(jnp.asarray(r)))
    _close(t.conj_apply(torch.as_tensor(r)), j.conj_apply(jnp.asarray(r)))


def test_ainv_breakdown_raises():
    tcsr, _, _ = _pair("poisson16")
    neg = tf.CSR(data=-tcsr.data, indices=tcsr.indices, row_ptr=tcsr.row_ptr,
                 shape=tcsr.shape)
    with pytest.raises(ValueError, match="AINV breakdown"):
        tp.AinvPreconditioner(neg, **CPU)


# -- block-Jacobi, IQR's normal equations, Krylov -------------------------------------


@pytest.mark.parametrize("b", [2, 4])
def test_block_jacobi_matches_jax(b):
    tcsr, jcsr, _ = _pair("poisson16")
    t = tp.BlockJacobiPreconditioner(matrix=tf.bsr_from_csr(tcsr, b))
    j = jp.BlockJacobiPreconditioner(matrix=jf.bsr_from_csr(jcsr, b))
    r = _rhs(256)
    _close(t(torch.as_tensor(r)), j(jnp.asarray(r)))
    got = tp.BlockJacobiPreconditioner().build(None, None, type("Op", (), {
        "matrix": tf.bsr_from_csr(tcsr, b)})())(torch.as_tensor(r))
    _close(got, j(jnp.asarray(r)))
    with pytest.raises(ValueError, match="BSR-backed"):
        tp.BlockJacobiPreconditioner().build(None, None, ts.make_operator(tcsr.matvec))


def _rect_sparse(m=160, n=64, seed=10):
    """The sparse rectangular A of ``tests/test_precond.py:361-392``."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n))
    for i in range(m):
        j = i * n // m
        a[i, j] = 2.0 + rng.random()
        if j + 1 < n:
            a[i, j + 1] = -1.0
        if j > 0:
            a[i, j - 1] = -0.5
    a[:, 0] += 0.1 * rng.standard_normal(m)
    return a


@pytest.mark.parametrize("shift,sweeps", [(0.0, None), (0.1, None), (0.0, 4)])
def test_iqr_matches_jax(shift, sweeps):
    a = _rect_sparse()
    rp, cols, vals = _triples_from_dense(a)
    for got, want in zip(tiqr.normal_equations_csr(rp, cols, vals, *a.shape),
                         jiqr.normal_equations_csr(rp, cols, vals, *a.shape)):
        np.testing.assert_array_equal(got, want)
    tcsr = tf.CSR(data=torch.as_tensor(vals), indices=torch.as_tensor(cols.astype(np.int32)),
                  row_ptr=torch.as_tensor(rp.astype(np.int32)), shape=a.shape)
    jcsr = jf.CSR(data=jnp.asarray(vals), indices=jnp.asarray(cols.astype(np.int32)),
                  row_ptr=jnp.asarray(rp.astype(np.int32)), shape=a.shape)
    t = tp.IqrPreconditioner(tcsr, shift=shift, sweeps=sweeps, **CPU)
    j = jp.IqrPreconditioner(jcsr, shift=shift, sweeps=sweeps)
    for ft, fj in ((t._r, j._r), (t._rt, j._rt)):
        for got, want in zip(ft, fj):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = _rhs(a.shape[1])
    _close(t(torch.as_tensor(y)), j(jnp.asarray(y)))
    _close(t.conj_apply(torch.as_tensor(y)), j.conj_apply(jnp.asarray(y)))


def test_krylov_with_axis_name_copies():
    pre = tp.KrylovPreconditioner(method="cg", num_iterations=3)
    other = pre.with_axis_name("x")
    assert other is not pre and other._axis_name == "x" and pre._axis_name is None
    with pytest.raises(ValueError, match="no operator"):
        pre(torch.ones(3, dtype=torch.float64))


# -- solver histories with each preconditioner ------------------------------------------


def _gershgorin(csr):
    """max_i Σ_j |a_ij|, an upper bound of the spectrum."""
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(tf.host(csr.row_ptr)))
    return float(np.bincount(rows, np.abs(tf.host(csr.data))).max())


def _pre(kind, tcsr, jcsr):
    if kind == "amg":
        return tp.AmgPreconditioner(tcsr, **CPU), jp.AmgPreconditioner(jcsr)
    if kind == "amg2":
        return (tp.AmgPreconditioner(tcsr, num_sweeps=2, coarse_size=8, **CPU),
                jp.AmgPreconditioner(jcsr, num_sweeps=2, coarse_size=8))
    if kind == "chebyshev":
        # λmax from Gershgorin's bound keeps p(A) positive definite (see
        # test_chebyshev_power_estimate_is_below_lambda_max_in_both).
        lmax = _gershgorin(tcsr)
        return (tp.ChebyshevPreconditioner(4, lambda_max=lmax),
                jp.ChebyshevPreconditioner(4, lambda_max=lmax))
    if kind == "SpaiPreconditioner":
        return tp.SpaiPreconditioner(tcsr, **CPU), jp.SpaiPreconditioner(jcsr)
    if kind == "krylov":
        return (tp.KrylovPreconditioner(method="cg", num_iterations=8),
                jp.KrylovPreconditioner(method="cg", num_iterations=8))
    if kind.startswith("block_jacobi"):
        b = int(kind[-1])
        return (tp.BlockJacobiPreconditioner(matrix=tf.bsr_from_csr(tcsr, b)),
                jp.BlockJacobiPreconditioner(matrix=jf.bsr_from_csr(jcsr, b)))
    if kind == "ainv":
        return (tp.AinvPreconditioner(tcsr, drop_tol=0.05, **CPU),
                jp.AinvPreconditioner(jcsr, drop_tol=0.05))
    cls, _, sweeps = kind.partition("/")
    sweeps = int(sweeps) if sweeps else None
    return (getattr(tp, cls)(tcsr, sweeps=sweeps, **CPU), getattr(jp, cls)(jcsr, sweeps=sweeps))


HISTORIES = [
    ("cg", "amg", "rect"), ("cg", "amg2", "rect"), ("cg", "amg", "poisson16"),
    ("cg", "chebyshev", "rect"), ("cg", "chebyshev", "poisson16"),
    ("cg", "IcPreconditioner", "poisson16"), ("cg", "IcPreconditioner/2", "poisson16"),
    ("cg", "SgsPreconditioner", "poisson16"), ("cg", "SgsPreconditioner/4", "poisson16"),
    ("cg", "ainv", "poisson16"), ("cg", "block_jacobi2", "poisson16"),
    ("cg", "block_jacobi4", "poisson16"),
    ("fgmres", "IluPreconditioner", "convdiff"), ("fgmres", "IluPreconditioner/3", "convdiff"),
    ("fgmres", "SpaiPreconditioner", "convdiff"), ("fgmres", "krylov", "poisson16"),
    ("fgmres", "krylov", "rect"),
]


@pytest.mark.parametrize("method,kind,name", HISTORIES)
def test_solver_history_with_preconditioner(method, kind, name):
    tcsr, jcsr, dense = _pair(name)
    tpre, jpre = _pre(kind, tcsr, jcsr)
    b = _rhs(tcsr.shape[0], mean_free=name == "rect")
    t, j = _solve_both(method, tcsr, jcsr, tpre, jpre, b)
    assert t.converged
    _same_history(t, j)
    r = dense @ t.x.numpy() - b
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)


def _jittered_ch_operator(side):
    """The Cahn–Hilliard step operator I − τσD + τγD² on a jittered Delaunay
    mesh (the smoke's kind of mesh, small), as host CSR triples."""
    from scipy.spatial import Delaunay

    from stormx_torch.fvm.divgrad import assemble_divgrad
    from stormx_torch.mesh import build_mesh

    g = np.linspace(0.0, 1.0, side)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    inner = ((pts > 0) & (pts < 1)).all(axis=1)
    pts[inner] += (np.random.default_rng(0).random((int(inner.sum()), 2)) - 0.5) * (
        0.7 / (side - 1))
    mesh = build_mesh(pts, Delaunay(pts).simplices).optimize_ordering()
    d = assemble_divgrad(mesh)
    a = tf.ell_add([(1.0, None), (-2e-3, d), (1e-7, tf.ell_spgemm(d, d))],
                   (mesh.num_cells, mesh.num_cells))
    return a, jf.CSR(data=jnp.asarray(tf.host(a.data)), indices=jnp.asarray(tf.host(a.indices)),
                     row_ptr=jnp.asarray(tf.host(a.row_ptr)), shape=a.shape)


def test_ic0_breaks_down_on_the_ch_operator_in_both():
    """The CH operator on a jittered mesh is not an M-matrix (the biharmonic
    τγD² dominates): IC(0) meets a non-positive pivot at the same row in both
    packages, which is why the smoke runs IC(0) and AINV on the diffusion
    step V + τ·L."""
    t, j = _jittered_ch_operator(24)
    with pytest.raises(ValueError, match="non-positive pivot") as t_err:
        tp.IcPreconditioner(t, **CPU)
    with pytest.raises(ValueError, match="non-positive pivot") as j_err:
        jp.IcPreconditioner(j)
    assert str(t_err.value) == str(j_err.value)
    # SGS needs only a nonzero diagonal, and takes it.
    _close(tp.SgsPreconditioner(t, sweeps=2, **CPU)(torch.ones(t.shape[0], dtype=torch.float64)),
           jp.SgsPreconditioner(j, sweeps=2)(jnp.ones(t.shape[0])))
