"""The adjoint product and the least-squares solvers of stormx_torch
(``LinearOperator.conj_mul``, ``make_symmetric_operator``, ``lsqr``,
``lsmr``) against the JAX package, in float64 on the same numpy-made
inputs.

Histories agree to 1e-10 relative with equal iteration counts, each entry
also allowed 1e-13 of the initial residual (``tests/test_torch_krylov.py``
says why).  The matrices are those of ``tests/test_solvers_extended.py:157-250``
(dense square, over- and underdetermined) and ``tests/test_precond.py:321-392``
(IQR on an ill-conditioned dense and a sparse rectangular A); the operator
is ``make_operator(A @ x, Aᵀ @ y)`` on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx import precond as jp
from stormx import solvers as js
from stormx.core.exceptions import StormError as JStormError
from stormx.sparse import formats as jf
from stormx_torch import precond as tp
from stormx_torch import solvers as ts
from stormx_torch.core.exceptions import StormError
from stormx_torch.sparse import formats as tf


def _square(seed, n=60):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + n * np.eye(n), rng.standard_normal(n)


def _rect(seed, m, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def _ill(seed=9, m=120, n=48):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) * np.logspace(0, 2.2, n), rng.standard_normal(m)


def _sparse(seed=10, m=160, n=64):
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
    return a, rng.standard_normal(m)


def _ops(a):
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    return (ts.make_operator(lambda x: at @ x, lambda y: at.T @ y),
            js.make_operator(lambda x: aj @ x, lambda y: aj.T @ y))


def _csrs(a):
    rows, cols = np.nonzero(a)
    rp = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    rp, cols, vals = np.cumsum(rp).astype(np.int32), cols.astype(np.int32), a[rows, cols]
    return (tf.CSR(data=torch.as_tensor(vals), indices=torch.as_tensor(cols),
                   row_ptr=torch.as_tensor(rp), shape=a.shape),
            jf.CSR(data=jnp.asarray(vals), indices=jnp.asarray(cols), row_ptr=jnp.asarray(rp),
                   shape=a.shape))


def _same_history(t, j):
    assert t.converged == bool(j.converged)
    assert t.num_iterations == int(j.num_iterations)
    k = t.num_iterations
    hj = np.asarray(j.history)[: k + 1]
    np.testing.assert_allclose(t.history.numpy()[: k + 1], hj, rtol=1e-10, atol=1e-13 * hj[0])


# -- the operator ------------------------------------------------------------------


def test_conj_mul_raises_without_an_adjoint():
    op = ts.make_operator(lambda x: 2.0 * x)
    x = torch.ones(3, dtype=torch.float64)
    assert torch.equal(op.mul(x), 2.0 * x)
    with pytest.raises(StormError, match="conjugate operator"):
        op.conj_mul(x)
    with pytest.raises(JStormError, match="conjugate operator"):
        js.make_operator(lambda x: 2.0 * x).conj_mul(jnp.ones(3))


def test_symmetric_operator_and_residual_norm():
    a, b = _square(0, 20)
    a = a + a.T
    at = torch.as_tensor(a)
    op = ts.make_symmetric_operator(lambda x: at @ x)
    jop = js.make_symmetric_operator(lambda x: jnp.asarray(a) @ x)
    x = np.random.default_rng(1).standard_normal(20)
    np.testing.assert_array_equal(op.conj_mul(torch.as_tensor(x)).numpy(),
                                  op(torch.as_tensor(x)).numpy())
    got = float(op.residual_norm(torch.as_tensor(b), torch.as_tensor(x)))
    want = float(jop.residual_norm(jnp.asarray(b), jnp.asarray(x)))
    assert abs(got - want) <= 1e-13 * want


def test_as_operator_keeps_the_adjoint():
    op = ts.make_operator(lambda x: x, lambda y: -y)
    assert ts.as_operator(op) is op
    assert float(ts.as_operator(op).conj_mul(torch.ones(1, dtype=torch.float64))) == -1.0


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
def test_least_squares_needs_the_adjoint(method):
    op = ts.make_operator(lambda x: x)
    with pytest.raises(StormError):
        ts.SOLVERS[method](op, torch.ones(3, dtype=torch.float64),
                           torch.zeros(3, dtype=torch.float64))


# -- histories ----------------------------------------------------------------------

TIGHT = dict(num_iterations=600, absolute_tolerance=1e-10, relative_tolerance=1e-10)
BUDGET = dict(num_iterations=300, absolute_tolerance=0.0, relative_tolerance=0.0)
CASES = {
    "square": (lambda: _square(0), TIGHT),
    "overdetermined": (lambda: _rect(1, 100, 40), dict(BUDGET, num_iterations=60)),
    # m = 30 rows: the bidiagonalization is exhausted after 30 steps, and
    # what follows is roundoff, which the packages sum in other orders.
    "underdetermined": (lambda: _rect(2, 30, 80), dict(BUDGET, num_iterations=25)),
    "square_lsmr": (lambda: _square(3), TIGHT),
}


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_history_matches_jax(method, case):
    make, opts = CASES[case]
    a, b = make()
    top, jop = _ops(a)
    n = a.shape[1]
    t = ts.SOLVERS[method](top, torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
                           options=ts.SolverOptions(**opts))
    j = js.SOLVERS[method](jop, jnp.asarray(b), jnp.zeros(n), options=js.SolverOptions(**opts))
    _same_history(t, j)
    x_j = np.asarray(j.x)
    assert np.linalg.norm(t.x.numpy() - x_j) <= 1e-9 * np.linalg.norm(x_j)
    if opts is TIGHT:
        np.testing.assert_allclose(t.x.numpy(), np.linalg.solve(a, b), atol=1e-6)


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
def test_underdetermined_min_norm(method):
    """``tests/test_solvers_extended.py``'s minimum-norm check, on the port."""
    a, b = _rect(2, 30, 80)
    top, _ = _ops(a)
    opts = ts.SolverOptions(num_iterations=200, absolute_tolerance=1e-12,
                            relative_tolerance=1e-12)
    res = ts.SOLVERS[method](top, torch.as_tensor(b), torch.zeros(80, dtype=torch.float64),
                             options=opts)
    x_ref, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(res.x.numpy(), x_ref, atol=1e-8)


@pytest.mark.parametrize("damp", [0.5, 3.0])
def test_lsmr_damped_matches_jax(damp):
    a, b = _rect(4, 50, 20)
    top, jop = _ops(a)
    opts = dict(num_iterations=80, absolute_tolerance=0.0, relative_tolerance=0.0)
    t = ts.lsmr(top, torch.as_tensor(b), torch.zeros(20, dtype=torch.float64), damp=damp,
                options=ts.SolverOptions(**opts))
    j = js.lsmr(jop, jnp.asarray(b), jnp.zeros(20), damp=damp, options=js.SolverOptions(**opts))
    _same_history(t, j)
    x_ref = np.linalg.solve(a.T @ a + damp**2 * np.eye(20), a.T @ b)
    np.testing.assert_allclose(t.x.numpy(), x_ref, atol=1e-8)


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
@pytest.mark.parametrize("case,budget,sweeps", [("ill", 15, None), ("sparse", 20, None),
                                                ("sparse", 20, 6)])
def test_iqr_history_matches_jax_and_cuts_the_error(method, case, budget, sweeps):
    """With IQR, both packages reach the same iterate at a fixed budget, and
    the error against ``lstsq`` is below the plain run's
    (``tests/test_precond.py:321-392``)."""
    a, b = (_ill if case == "ill" else _sparse)()
    top, jop = _ops(a)
    tcsr, jcsr = _csrs(a)
    n = a.shape[1]
    opts = dict(num_iterations=budget, absolute_tolerance=0.0, relative_tolerance=0.0)
    fn_t, fn_j = ts.SOLVERS[method], js.SOLVERS[method]
    t = fn_t(top, torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
             precond=tp.IqrPreconditioner(tcsr, sweeps=sweeps, device="cpu"),
             options=ts.SolverOptions(**opts))
    j = fn_j(jop, jnp.asarray(b), jnp.zeros(n), precond=jp.IqrPreconditioner(jcsr, sweeps=sweeps),
             options=js.SolverOptions(**opts))
    _same_history(t, j)
    x_j = np.asarray(j.x)
    assert np.linalg.norm(t.x.numpy() - x_j) <= 1e-9 * np.linalg.norm(x_j)
    plain = fn_t(top, torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
                 options=ts.SolverOptions(**opts))
    x_ref, *_ = np.linalg.lstsq(a, b, rcond=None)
    err_plain = np.abs(plain.x.numpy() - x_ref).max()
    err_pre = np.abs(t.x.numpy() - x_ref).max()
    assert err_pre < err_plain
