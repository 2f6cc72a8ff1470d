"""CG, Jacobi and the iteration driver of stormx_torch against the JAX
package and against a NumPy hand-run of the reference CG, in float64.

Histories agree to 1e-10 relative with equal iteration counts: torch and
XLA sum dot products in different orders, and the conditioning of the
operator amplifies that difference along the recurrence
(``tests/test_milestone_a.py:16-21``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.ops import safe_divide as j_safe_divide
from stormx.ops import vector as jv
from stormx.precond import JacobiPreconditioner as JJacobi
from stormx.solvers import SolverOptions as JOptions
from stormx.solvers import cg as j_cg
from stormx.solvers import make_operator as j_make_operator
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import safe_divide, safe_inverse
from stormx_torch.ops import vector as tv
from stormx_torch.precond import JacobiPreconditioner
from stormx_torch.solvers import SolverOptions, cg, make_operator, run_iterative
from stormx_torch.sparse.formats import csr_from_dense, ell_from_csr

N = 40


def _spd(n, rng, density=0.3):
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    return a @ a.T + n * np.eye(n)


def _mesh_spd():
    """A mesh Laplacian shifted by 0.1·I: 240 unknowns, cond ~1e2, so CG
    converges well before n iterations (past n, rounding decides the count)."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import structured_tri_rect

    return assemble_laplacian(structured_tri_rect(12, 10)).to_csr().todense().numpy() \
        + 0.1 * np.eye(240)


def np_safe_divide(x, y):
    return 0.0 if y == 0 else x / y


def np_cg(a, b, iters, diag=None):
    """Hand-run of the reference CG (SolverCg.hpp pseudocode); a copy of
    ``tests/test_golden_histories.py:np_cg``."""
    pre = (lambda r: r / diag) if diag is not None else (lambda r: r)
    x = np.zeros(len(b))
    r = b - a @ x
    z = pre(r)
    p = z
    gamma = r @ z
    errs = [np.linalg.norm(r)]
    for _ in range(iters):
        z = a @ p
        alpha = np_safe_divide(gamma, p @ z)
        x = x + alpha * p
        r = r - alpha * z
        z = pre(r)
        gamma_new = r @ z
        beta = np_safe_divide(gamma_new, gamma)
        gamma = gamma_new
        p = z + beta * p
        errs.append(np.linalg.norm(r))
    return x, np.array(errs)


def _fixed(k):
    return dict(num_iterations=k, absolute_tolerance=0.0, relative_tolerance=0.0)


def _both(a, b, opts, jacobi):
    dt = torch.as_tensor(np.diag(a).copy())
    t = cg(make_operator(lambda x: torch.as_tensor(a) @ x), torch.as_tensor(b),
           torch.zeros(len(b), dtype=torch.float64),
           precond=JacobiPreconditioner(diag=dt) if jacobi else None,
           options=SolverOptions(**opts))
    j = j_cg(j_make_operator(lambda x: jnp.asarray(a) @ x), jnp.asarray(b),
             jnp.zeros(len(b)), precond=JJacobi(diag=jnp.asarray(np.diag(a))) if jacobi else None,
             options=JOptions(**opts))
    return t, j


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("matrix", ["spd", "mesh"])
def test_cg_matches_jax(rng, jacobi, matrix):
    a = _spd(N, rng) if matrix == "spd" else _mesh_spd()
    b = rng.standard_normal(len(a))
    opts = dict(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-8)
    t, j = _both(a, b, opts, jacobi)
    assert t.converged == bool(j.converged)
    assert t.num_iterations == int(j.num_iterations) > 0
    k = t.num_iterations
    ht, hj = t.history.numpy(), np.asarray(j.history)
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=1e-10)
    assert np.isnan(ht[k + 1:]).all() and np.isnan(hj[k + 1:]).all()
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(t.relative_error), float(j.relative_error), rtol=1e-10)


@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_matches_numpy_golden(rng, jacobi):
    a = _spd(N, rng)
    b = rng.standard_normal(N)
    t, _ = _both(a, b, _fixed(15), jacobi)
    x_ref, h_ref = np_cg(a, b, 15, np.diag(a) if jacobi else None)
    np.testing.assert_allclose(t.history.numpy(), h_ref, rtol=1e-10)
    np.testing.assert_allclose(t.x.numpy(), x_ref, rtol=1e-10, atol=1e-12)


def test_cg_on_sparse_operator(rng):
    a = _spd(N, rng, density=0.1)
    b = rng.standard_normal(N)
    ell = ell_from_csr(csr_from_dense(a))
    t = cg(ell, torch.as_tensor(b), torch.zeros(N, dtype=torch.float64),
           precond=JacobiPreconditioner(matrix=ell), options=SolverOptions(**_fixed(10)))
    _, h_ref = np_cg(a, b, 10, np.diag(a))
    np.testing.assert_allclose(t.history.numpy(), h_ref, rtol=1e-10)


class TestStoppingRule:
    """The edge cases of ``stormx/solvers/base.py:1-25``."""

    def test_preloop_absolute_exit(self, rng):
        a = _spd(N, rng)
        x = rng.standard_normal(N)
        b = a @ x
        opts = dict(num_iterations=50, absolute_tolerance=1e-3, relative_tolerance=1e-6)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v), torch.as_tensor(b),
                 torch.as_tensor(x), options=SolverOptions(**opts))
        jres = j_cg(j_make_operator(lambda v: jnp.asarray(a) @ v), jnp.asarray(b),
                    jnp.asarray(x), options=JOptions(**opts))
        assert res.converged and res.num_iterations == 0 == int(jres.num_iterations)
        assert float(res.relative_error) == 1.0
        h = res.history.numpy()
        assert h[0] == float(res.absolute_error) and np.isnan(h[1:]).all()

    def test_relative_rule_only_after_an_iteration(self, rng):
        # atol = 0 disables the pre-loop exit even for an exact x0.
        a = _spd(N, rng)
        x = rng.standard_normal(N)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v), torch.as_tensor(a @ x),
                 torch.as_tensor(x), options=SolverOptions(absolute_tolerance=0.0))
        assert res.num_iterations >= 1

    def test_zero_tolerances_run_every_iteration(self, rng):
        a = _spd(N, rng)
        b = rng.standard_normal(N)
        t, j = _both(a, b, _fixed(7), jacobi=False)
        assert t.num_iterations == 7 == int(j.num_iterations)
        assert not t.converged and not bool(j.converged)
        assert not np.isnan(t.history.numpy()).any()

    def test_no_history(self, rng):
        a = _spd(N, rng)
        res = cg(make_operator(lambda v: torch.as_tensor(a) @ v),
                 torch.as_tensor(rng.standard_normal(N)), torch.zeros(N, dtype=torch.float64),
                 options=SolverOptions(record_history=False))
        assert res.history is None and res.converged

    def test_finalize_skipped_after_zero_iterations(self):
        calls = []

        def init(x):
            return None, torch.tensor(0.0, dtype=torch.float64)

        def iterate(it, x, st):
            raise AssertionError("no iteration may run")

        def finalize(it, x, st):
            calls.append(it)
            return x

        opts = SolverOptions(absolute_tolerance=1e-6)
        res = run_iterative(init, iterate, finalize, torch.zeros(3), opts)
        assert res.num_iterations == 0 and res.converged and calls == []

    def test_finalize_runs_once_after_iterations(self):
        calls = []

        def init(x):
            return 0, torch.tensor(1.0, dtype=torch.float64)

        def iterate(it, x, st):
            return x + 1, st + 1, torch.tensor(0.5 ** (it + 1), dtype=torch.float64)

        def finalize(it, x, st):
            calls.append((it, st))
            return x * 10

        opts = SolverOptions(num_iterations=100, absolute_tolerance=0.0, relative_tolerance=0.1)
        res = run_iterative(init, iterate, finalize, torch.zeros(()), opts)
        # 0.5**4 = 0.0625 < 0.1 is the first relative error under the tolerance
        assert res.num_iterations == 4 and calls == [(4, 4)] and float(res.x) == 40.0
        np.testing.assert_allclose(res.history.numpy()[:5], [1, 0.5, 0.25, 0.125, 0.0625])


def test_safe_divide_and_vector_ops(rng):
    x = rng.standard_normal(17)
    y = rng.standard_normal(17)
    y[3] = 0.0
    np.testing.assert_array_equal(safe_divide(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
                                  np.asarray(j_safe_divide(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(safe_inverse(torch.as_tensor(y)).numpy()[3], 0.0)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    pairs = [
        (tv.dot(tx, ty), jv.dot(jx, jy)),
        (tv.norm_2(tx), jv.norm_2(jx)),
        (tv.norm_1(tx), jv.norm_1(jx)),
        (tv.norm_inf(tx), jv.norm_inf(jx)),
        (tv.norm_p(tx, 3), jv.norm_p(jx, 3)),
        (tv.axpy(0.3, tx, ty), jv.axpy(0.3, jx, jy)),
        (tv.xpay(tx, 0.3, ty), jv.xpay(jx, 0.3, jy)),
        (tv.lincomb([0.5, -2.0], [tx, ty]), jv.lincomb([0.5, -2.0], [jx, jy])),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13, atol=1e-15)
    zc = torch.as_tensor(x + 1j * y)
    np.testing.assert_allclose(complex(tv.dot(zc, zc)), np.vdot(x + 1j * y, x + 1j * y))
    with pytest.raises(StormError, match="make_device_mesh"):
        tv.dot(tx, ty, axis_name="i")
