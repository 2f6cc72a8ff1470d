"""The Krylov suite of stormx_torch (``solve`` and every ported method)
against the JAX package in float64, on the same numpy-made inputs.

Histories agree to 1e-10 relative with equal iteration counts, as
``tests/test_torch_solvers.py`` holds ``cg``: torch and XLA sum dot
products in other orders, and the recurrences carry that along.  Each
history entry is also allowed 1e-13 of the initial residual: the runs stop
at 1e-10 of it, where a roundoff of 1e-16·‖r₀‖ in the dots is already
~1e-6 relative (measured: up to 3.6e-6 relative, 3.6e-16·‖r₀‖ absolute, on
Richardson's last entry), while the solutions agree to ~2e-16.  ``idrs``
takes the same caller-supplied shadow vectors on both sides, because
``torch.Generator`` and ``jax.random`` draw other numbers from one seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_nonsym_matrix, make_spd_matrix
from stormx import solvers as js
from stormx.core.exceptions import StormError as JStormError
from stormx.ops import math as jm
from stormx.ops import vector as jv
from stormx.precond import JacobiPreconditioner as JJacobi
from stormx_torch import solvers as ts
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import math as tm
from stormx_torch.ops import vector as tv
from stormx_torch.precond import JacobiPreconditioner

N = 24
METHODS = ["richardson", "cgs", "bicgstab", "bicgstab_l", "tfqmr", "tfqmr1", "idrs",
           "gmres", "fgmres", "lgmres", "lfgmres"]
# Methods that read pre_side (bicgstab_l and richardson apply 𝓟 one way only;
# fgmres and lfgmres force the right side).
SIDED = ["cgs", "bicgstab", "tfqmr", "idrs", "gmres", "lgmres"]


def _extra(method, n, rng):
    if method == "richardson":
        return {"relaxation_factor": 0.2}
    if method == "idrs":
        return {"shadow": rng.standard_normal((3, n))}
    if method == "gmres":
        return {"restart": 7}  # several restarts within the run
    if method in ("lgmres", "lfgmres"):
        return {"restart": 5, "augment": 2}  # restarts that take up error directions
    return {}


def _run_both(method, a, b, *, jacobi, side="right", tol=1e-10, iters=300, extra=None,
              x0=None):
    opts = dict(num_iterations=iters, absolute_tolerance=0.0, relative_tolerance=tol,
                pre_side=side)
    extra = dict(extra or {})
    x0 = np.zeros(len(b)) if x0 is None else x0
    t_extra = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
               for k, v in extra.items()}
    j_extra = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in extra.items()}
    t = ts.solve(ts.make_operator(lambda x: torch.as_tensor(a) @ x), torch.as_tensor(b),
                 torch.as_tensor(x0), method=method,
                 precond=JacobiPreconditioner(diag=torch.as_tensor(np.diag(a).copy()))
                 if jacobi else None,
                 options=ts.SolverOptions(**opts), **t_extra)
    j = js.solve(js.make_operator(lambda x: jnp.asarray(a) @ x), jnp.asarray(b),
                 jnp.asarray(x0), method=method,
                 precond=JJacobi(diag=jnp.asarray(np.diag(a))) if jacobi else None,
                 options=js.SolverOptions(**opts), **j_extra)
    return t, j


def _assert_same(t, j):
    assert t.converged == bool(j.converged)
    k = t.num_iterations
    assert k == int(j.num_iterations) > 0
    ht, hj = t.history.numpy(), np.asarray(j.history)
    np.testing.assert_allclose(ht[: k + 1], hj[: k + 1], rtol=1e-10, atol=1e-13 * hj[0])
    assert np.isnan(ht[k + 1:]).all()
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(j.x)).max())


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("method", METHODS)
def test_method_matches_jax_spd(method, jacobi, rng):
    a = make_spd_matrix(N, rng)
    b = rng.standard_normal(N)
    if method == "richardson":  # ω·𝓟𝓐 must be a contraction
        a = np.eye(N) * 4 + 0.1 * (a - np.diag(np.diag(a))) / N
    t, j = _run_both(method, a, b, jacobi=jacobi, extra=_extra(method, N, rng))
    assert t.converged
    _assert_same(t, j)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("method", SIDED)
def test_sided_method_matches_jax_nonsym(method, side, rng):
    a = make_nonsym_matrix(N, rng)
    b = rng.standard_normal(N)
    t, j = _run_both(method, a, b, jacobi=True, side=side, extra=_extra(method, N, rng))
    assert t.converged
    _assert_same(t, j)


@pytest.mark.parametrize("method", ["bicgstab_l", "fgmres", "gmres", "lgmres", "lfgmres"])
def test_fixed_iteration_count_and_partial_cycle(method, rng):
    """Zero tolerances run every iteration; 11 iterations of GMRES(4), or of
    LGMRES(4, 3) with 7 steps a cycle, end in a partial cycle, which the exit
    finalize folds in."""
    a = make_nonsym_matrix(N, rng)
    b = rng.standard_normal(N)
    extra = {"restart": 4} if "gmres" in method else {"l": 3}
    t, j = _run_both(method, a, b, jacobi=True, tol=0.0, iters=11, extra=extra)
    assert t.num_iterations == 11 and not t.converged
    _assert_same(t, j)


@pytest.mark.parametrize("orthog", ["mgs", "cgs2"])
def test_gmres_orthogonalizations(orthog, rng):
    a = make_nonsym_matrix(N, rng)
    b = rng.standard_normal(N)
    t, j = _run_both("gmres", a, b, jacobi=False, extra={"restart": 6, "orthog": orthog})
    _assert_same(t, j)


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("orthog", ["mgs", "cgs2"])
@pytest.mark.parametrize("method", ["lgmres", "lfgmres"])
def test_lgmres_orthogonalizations(method, orthog, jacobi, rng):
    a = make_nonsym_matrix(N, rng)
    b = rng.standard_normal(N)
    t, j = _run_both(method, a, b, jacobi=jacobi,
                     extra={"restart": 4, "augment": 3, "orthog": orthog})
    assert t.converged
    _assert_same(t, j)


def test_idrs_default_shadow_space_converges(rng):
    a = make_nonsym_matrix(N, rng)
    x_true = rng.standard_normal(N)
    res = ts.idrs(ts.make_operator(lambda x: torch.as_tensor(a) @ x),
                  torch.as_tensor(a @ x_true), torch.zeros(N, dtype=torch.float64),
                  options=ts.SolverOptions(absolute_tolerance=1e-10, relative_tolerance=1e-10))
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-8)


class TestApi:
    def test_solve_default_x0_and_cg(self, rng):
        a = make_spd_matrix(N, rng)
        x_true = rng.standard_normal(N)
        res = ts.solve(ts.make_operator(lambda x: torch.as_tensor(a) @ x),
                       torch.as_tensor(a @ x_true),
                       options=ts.SolverOptions(absolute_tolerance=1e-10,
                                                relative_tolerance=1e-10))
        np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-7)

    def test_solve_non_uniform_matches_jax(self, rng):
        a = make_spd_matrix(N, rng)
        shift = rng.standard_normal(N)
        b = rng.standard_normal(N)
        opts = dict(absolute_tolerance=0.0, relative_tolerance=1e-10)
        t = ts.solve_non_uniform(
            ts.make_operator(lambda x: torch.as_tensor(a) @ x + torch.as_tensor(shift)),
            torch.as_tensor(b), torch.zeros(N, dtype=torch.float64), method="bicgstab",
            options=ts.SolverOptions(**opts))
        j = js.solve_non_uniform(
            js.make_operator(lambda x: jnp.asarray(a) @ x + jnp.asarray(shift)),
            jnp.asarray(b), jnp.zeros(N), method="bicgstab", options=js.SolverOptions(**opts))
        _assert_same(t, j)
        np.testing.assert_allclose(a @ t.x.numpy() + shift, b, atol=1e-8)

    # lsqr and lsmr are ported: on an operator without the adjoint they raise
    # StormError, as the JAX package's do.
    @pytest.mark.parametrize("method,error,match", [
        ("nope", ValueError, "cg"), ("lsqr", StormError, "conjugate"),
        ("lsmr", StormError, "conjugate"), ("minres", ValueError, "cg"),
    ], ids=["nope", "lsqr", "lsmr", "minres"])
    def test_unknown_or_unported_method_raises(self, method, error, match, rng):
        with pytest.raises(error, match=match):
            ts.solve(ts.make_operator(lambda x: x), torch.zeros(3), method=method)

    @pytest.mark.parametrize("method", ["lgmres", "newton"])
    def test_newly_ported_methods_dispatch(self, method):
        b = torch.arange(1.0, 4.0, dtype=torch.float64)
        res = ts.solve(ts.make_operator(lambda x: 2.0 * x), b, method=method,
                       options=ts.SolverOptions(absolute_tolerance=1e-12,
                                                relative_tolerance=1e-12))
        assert res.converged
        np.testing.assert_allclose(res.x.numpy(), b.numpy() / 2.0, rtol=1e-12)

    def test_solvers_lists_the_ported_methods(self):
        assert sorted(ts.SOLVERS) == sorted(["cg", *METHODS, "lsqr", "lsmr", "newton", "jfnk"])
        assert set(ts.SOLVERS) == set(js.SOLVERS)

    @pytest.mark.parametrize("method", SIDED)
    def test_symmetric_side_raises_like_jax(self, method, rng):
        a = make_nonsym_matrix(N, rng)
        b = rng.standard_normal(N)
        with pytest.raises(StormError, match="symmetric") as et:
            _run_both(method, a, b, jacobi=True, side="symmetric")
        with pytest.raises(JStormError, match="symmetric") as ej:
            js.solve(js.make_operator(lambda x: jnp.asarray(a) @ x), jnp.asarray(b),
                     method=method, precond=JJacobi(diag=jnp.asarray(np.diag(a))),
                     options=js.SolverOptions(pre_side="symmetric"))
        assert str(et.value) == str(ej.value)

    def test_symmetric_side_without_precond_runs(self, rng):
        a = make_nonsym_matrix(N, rng)
        b = rng.standard_normal(N)
        t, j = _run_both("gmres", a, b, jacobi=False, side="symmetric")
        _assert_same(t, j)

    def test_identity_preconditioner(self, rng):
        a = make_nonsym_matrix(N, rng)
        b = rng.standard_normal(N)
        op = ts.make_operator(lambda x: torch.as_tensor(a) @ x)
        opts = ts.SolverOptions(absolute_tolerance=0.0, relative_tolerance=1e-10)
        with_p = ts.bicgstab(op, torch.as_tensor(b), torch.zeros(N, dtype=torch.float64),
                             precond=ts.IdentityPreconditioner(), options=opts)
        without = ts.bicgstab(op, torch.as_tensor(b), torch.zeros(N, dtype=torch.float64),
                              options=opts)
        assert with_p.num_iterations == without.num_iterations
        np.testing.assert_allclose(with_p.history.numpy(), without.history.numpy(),
                                   rtol=1e-12)


def test_math_and_stacked_helpers_match_jax(rng):
    for a, b in ((3.0, 4.0), (0.0, 0.0), (-2.0, 0.5), (0.0, -1.5)):
        got = tm.sym_ortho(torch.tensor(a, dtype=torch.float64), torch.tensor(b, dtype=torch.float64))
        want = jm.sym_ortho(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-15)
    x = rng.standard_normal(9)
    np.testing.assert_array_equal(tm.sign(torch.as_tensor(x)).numpy(), np.asarray(jm.sign(x)))

    s = rng.standard_normal((4, 9))
    vec = rng.standard_normal(9)
    coeffs = rng.standard_normal(4)
    T, J = torch.as_tensor(s.copy()), jnp.asarray(s)
    np.testing.assert_array_equal(tv.stacked_zeros(torch.as_tensor(vec), 3).numpy(),
                                  np.asarray(jv.stacked_zeros(jnp.asarray(vec), 3)))
    np.testing.assert_allclose(tv.dots_stacked(T, torch.as_tensor(vec)).numpy(),
                               np.asarray(jv.dots_stacked(J, jnp.asarray(vec))), rtol=1e-13)
    np.testing.assert_allclose(tv.lincomb_stacked(torch.as_tensor(coeffs), T).numpy(),
                               np.asarray(jv.lincomb_stacked(jnp.asarray(coeffs), J)),
                               rtol=1e-13)
    np.testing.assert_array_equal(tv.roll_stacked(T, 1).numpy(),
                                  np.asarray(jv.roll_stacked(J, 1)))
    np.testing.assert_array_equal(tv.get_stacked(T, 2).numpy(), np.asarray(jv.get_stacked(J, 2)))
    out = tv.set_stacked(T, 1, torch.as_tensor(vec))
    assert out is T
    np.testing.assert_array_equal(T.numpy(), np.asarray(jv.set_stacked(J, 1, jnp.asarray(vec))))
    a, b = torch.as_tensor(x), torch.as_tensor(-x)
    for pred in (True, False):
        np.testing.assert_array_equal(tv.tree_where(torch.tensor(pred), a, b).numpy(),
                                      np.asarray(jv.tree_where(jnp.asarray(pred), x, -x)))
