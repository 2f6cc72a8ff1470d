"""``newton`` and ``jfnk`` of stormx_torch against the JAX package on the
four problems of ``tests/test_solvers.py`` (``TestNonlinear``), on the same
numpy-made inputs.

All in float64, with equal iteration counts and outcomes:
* ``newton`` (exact Jacobian through ``torch.func.jvp`` / ``jax.jvp``):
  histories within 1e-10 relative (1e-13 of the initial residual allowed
  besides, as in ``tests/test_torch_krylov.py``), since the two sides sum dot
  products in other orders and the recurrences carry that along.  The
  undamped run on the atan problem diverges from x₀ = 20 on both sides (to
  ~1e119 and ~1e148 in six iterations): it runs three iterations, the first
  two held to 1e-10 and the third to 1e-6 (measured 4.3e-8).  Its Jacobian
  0.01·L + diag(1/(1 + x²)) is nearly singular at x ≈ 20 (L has the constant
  nullspace), so the inner BiCGStab amplifies the roundoff gap.
* ``jfnk``: solutions within 1e-10 relative (measured ≤ 3.5e-13), histories
  within 1e-7 of the initial residual (measured ≤ 7.9e-9).  The finite-
  difference product divides by δ = μ/‖y‖ with μ ≈ 1.5e-8·√(1 + ‖x‖), so a
  last-bit difference between torch's and XLA's sums becomes ~1e-8 relative
  in J·y; no ordering of the port's sums removes that.

The packed SlicedELL operator is float32 only, so the Newton run whose
default Jacobian goes through its ``torch.autograd.Function`` (``jvp``) is
float32.  ``jax.jvp`` does not go through the JAX ``PackedSELL`` in interpret
mode (it has no JVP rule), so the JAX side passes the same Jacobian,
0.01·A·y + y/(1 + x²), explicitly.  The inner BiCGStab stops at 1e-5 on both
sides.  The damped path from x₀ = 20 is sensitive to float32 roundoff: both
sides converge, the iteration counts lie within 20% of each other, the first
three iterations' residuals within 1e-4 relative, and the solutions within
1e-4 relative (measured 9.5e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_spd_matrix
from stormx import solvers as js
from stormx.fvm.divgrad import assemble_laplacian as j_assemble_laplacian
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.ops import pallas_sell2 as jp
from stormx.sparse import formats as jf
from stormx.sparse import windowed as jw
from stormx_torch import interop
from stormx_torch import solvers as ts
from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.ops import sell_packed as tp
from stormx_torch.sparse import windowed as tw


def _assert_same(t, j, *, upto=None, history_atol=1e-13):
    """Equal outcomes and iteration counts; histories within 1e-10 relative
    or ``history_atol`` of the initial residual (up to entry ``upto``)."""
    assert t.converged == bool(j.converged)
    k = t.num_iterations
    assert k == int(j.num_iterations) > 0
    ht, hj = t.history.numpy(), np.asarray(j.history)
    n = k + 1 if upto is None else upto + 1
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=1e-10, atol=history_atol * hj[0])
    assert np.isnan(ht[k + 1:]).all()
    if upto is None:
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=1e-10,
                                   atol=1e-12 * np.abs(np.asarray(j.x)).max())


def _cubic(n, rng):
    """A(x) = L·x + x³ with L SPD (``test_jfnk_nonlinear``)."""
    L = make_spd_matrix(n, rng) / 10
    x_true = rng.standard_normal(n) * 0.5
    return L, (lambda x: torch.as_tensor(L) @ x + x**3), (lambda x: jnp.asarray(L) @ x + x**3), \
        L @ x_true + x_true**3


def test_jfnk_cubic_matches_jax(rng):
    _, t_op, j_op, b = _cubic(10, rng)
    opts = dict(absolute_tolerance=1e-9, relative_tolerance=1e-9)
    t = ts.jfnk(t_op, torch.as_tensor(b), torch.zeros(10, dtype=torch.float64),
                options=ts.SolverOptions(**opts))
    j = js.jfnk(j_op, jnp.asarray(b), jnp.zeros(10), options=js.SolverOptions(**opts))
    assert t.converged
    _assert_same(t, j, history_atol=1e-7)


@pytest.mark.parametrize("forcing", [None, "ew"])
def test_jfnk_forcing_matches_jax(forcing, rng):
    _, t_op, j_op, b = _cubic(12, rng)
    opts = dict(absolute_tolerance=1e-9, relative_tolerance=1e-9)
    t = ts.jfnk(t_op, torch.as_tensor(b), torch.zeros(12, dtype=torch.float64),
                options=ts.SolverOptions(**opts), forcing=forcing)
    j = js.jfnk(j_op, jnp.asarray(b), jnp.zeros(12), options=js.SolverOptions(**opts),
                forcing=forcing)
    assert t.converged
    _assert_same(t, j, history_atol=1e-7)


@pytest.mark.parametrize("line_search", [None, "armijo"])
def test_newton_tanh_autodiff_matches_jax(line_search, rng):
    L = make_spd_matrix(10, rng) / 10
    x_true = rng.standard_normal(10) * 0.3
    b = L @ x_true + np.tanh(x_true)
    opts = dict(absolute_tolerance=1e-10, relative_tolerance=1e-10)
    t = ts.newton(lambda x: torch.as_tensor(L) @ x + torch.tanh(x), torch.as_tensor(b),
                  torch.zeros(10, dtype=torch.float64), options=ts.SolverOptions(**opts),
                  line_search=line_search)
    j = js.newton(lambda x: jnp.asarray(L) @ x + jnp.tanh(x), jnp.asarray(b), jnp.zeros(10),
                  options=js.SolverOptions(**opts), line_search=line_search)
    assert t.converged
    np.testing.assert_allclose(t.x.numpy(), x_true, atol=1e-7)
    _assert_same(t, j)


def _atan_problem(rng):
    """0.01·L·x + atan(x) on the Laplacian of a 6×6 structured triangle
    mesh, x₀ = 20 (``test_newton_armijo_globalizes_where_full_step_diverges``)."""
    Lj = j_assemble_laplacian(j_rect(6, 6)).to_csr()
    Lt = assemble_laplacian(structured_tri_rect(6, 6)).to_csr()
    n = Lt.shape[0]
    x_true = rng.standard_normal(n) * 0.2
    b = np.array(0.01 * Lj.matvec(jnp.asarray(x_true)) + jnp.arctan(x_true))
    return Lj, Lt, n, x_true, b


@pytest.mark.parametrize("line_search", [None, "armijo"])
def test_newton_atan_on_laplacian_matches_jax(line_search, rng):
    Lj, Lt, n, x_true, b = _atan_problem(rng)
    # The undamped run diverges, and each of its inner solves runs to the cap:
    # three iterations show it.
    opts = dict(absolute_tolerance=1e-9, relative_tolerance=1e-12,
                num_iterations=3 if line_search is None else 40)
    t = ts.newton(lambda x: 0.01 * Lt.matvec(x) + torch.atan(x), torch.as_tensor(b),
                  torch.full((n,), 20.0, dtype=torch.float64), options=ts.SolverOptions(**opts),
                  line_search=line_search)
    j = js.newton(lambda x: 0.01 * Lj.matvec(x) + jnp.arctan(x), jnp.asarray(b),
                  jnp.full(n, 20.0), options=js.SolverOptions(**opts), line_search=line_search)
    if line_search is None:
        assert not t.converged  # the full step overshoots, on both sides
        _assert_same(t, j, upto=2)
        np.testing.assert_allclose(t.history[3].item(), float(j.history[3]), rtol=1e-6)
    else:
        assert t.converged
        np.testing.assert_allclose(t.x.numpy(), x_true, atol=1e-6)
        _assert_same(t, j)


def test_jfnk_from_saturation_fails_on_both_sides(rng):
    """JFNK has no line search: from x₀ = 20 on the atan problem its full
    steps overshoot, in the JAX package as in the port (``chip_smoke.py``
    therefore starts its gated JFNK run at 0).  Both sides run eight
    iterations without converging, their first two residuals within JFNK's
    tolerance above, and end above where they started."""
    Lj, Lt, n, _, b = _atan_problem(rng)
    opts = dict(absolute_tolerance=0.0, relative_tolerance=1e-10, num_iterations=8)
    t = ts.jfnk(lambda x: 0.01 * Lt.matvec(x) + torch.atan(x), torch.as_tensor(b),
                torch.full((n,), 20.0, dtype=torch.float64), options=ts.SolverOptions(**opts),
                forcing="ew")
    j = js.jfnk(lambda x: 0.01 * Lj.matvec(x) + jnp.arctan(x), jnp.asarray(b),
                jnp.full(n, 20.0), options=js.SolverOptions(**opts), forcing="ew")
    assert not t.converged and not bool(j.converged)
    assert t.num_iterations == int(j.num_iterations) == 8
    np.testing.assert_allclose(t.history[:2].numpy(), np.asarray(j.history[:2]), rtol=1e-10,
                               atol=1e-7 * float(j.history[0]))
    assert float(t.history[8]) > float(t.history[0]) and float(j.history[8]) > float(j.history[0])


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name)) if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("variant", tp.VARIANTS)
def test_newton_default_jacobian_through_packed_operator(variant, rng):
    """Float32 Newton with Armijo on the atan problem over a 24×20 mesh,
    the Laplacian as one packing fed to both packages."""
    c = j_assemble_laplacian(j_rect(24, 20)).to_csr()
    cj = jf.CSR(data=c.data.astype(jnp.float32), indices=c.indices, row_ptr=c.row_ptr,
                shape=c.shape)
    sj, _ = jw.sell_from_csr(cj, block_rows=128, mode="onehot", reorder=False)
    pj = jp.pack_sell(sj, variant)
    pt = interop.packed_from_fields(_fields(pj), device="cpu")
    ct = interop.csr_from_fields(_fields(cj), device="cpu")
    st, _ = tw.sell_from_csr(ct, block_rows=128, mode="cuda", reorder=False)
    assert np.array_equal(tp.pack_sell(st, variant).idx.numpy(), pt.idx.numpy())
    n = c.shape[0]
    x_true = (rng.standard_normal(n) * 0.2).astype(np.float32)
    b = np.array(0.01 * pj.matvec(jnp.asarray(x_true), interpret=True) + jnp.arctan(x_true))
    opts = dict(absolute_tolerance=0.0, relative_tolerance=1e-5, num_iterations=40)
    inner = dict(absolute_tolerance=0.0, relative_tolerance=1e-5, num_iterations=200,
                 record_history=False)
    t = ts.newton(lambda x: 0.01 * pt.matvec(x) + torch.atan(x), torch.as_tensor(b),
                  torch.full((n,), 20.0), options=ts.SolverOptions(**opts), line_search="armijo",
                  inner_solve=lambda J, r, t0: ts.bicgstab(J, r, t0,
                                                           options=ts.SolverOptions(**inner)))
    j = jax.jit(lambda bb: js.newton(
        lambda x: 0.01 * pj.matvec(x, interpret=True) + jnp.arctan(x), bb,
        jnp.full(n, 20.0, jnp.float32), options=js.SolverOptions(**opts), line_search="armijo",
        jacobian=lambda x: js.make_operator(
            lambda y: 0.01 * pj.matvec(y, interpret=True) + y / (1.0 + x * x)),
        inner_solve=lambda J, r, t0: js.bicgstab(J, r, t0, options=js.SolverOptions(**inner))))(
        jnp.asarray(b))
    assert t.converged and bool(j.converged)
    # float32 roundoff moves the damped path after a few steps (measured:
    # 23 and 26 iterations, histories within 8e-6 over the first three).
    assert abs(t.num_iterations - int(j.num_iterations)) <= 0.2 * int(j.num_iterations)
    np.testing.assert_allclose(t.history[:4].numpy(), np.asarray(j.history[:4]), rtol=1e-4)
    x_j = np.asarray(j.x)
    assert np.linalg.norm(t.x.numpy() - x_j) <= 1e-4 * np.linalg.norm(x_j)
    assert np.abs(t.x.numpy() - x_true).max() <= 1e-3
    assert tp.launches == {"matmul": 0, "gather": 0}


def test_unknown_line_search_and_forcing_raise_like_jax():
    z = torch.zeros(3, dtype=torch.float64)
    for t_fn, j_fn, kw in ((ts.newton, js.newton, {"line_search": "wolfe"}),
                           (ts.jfnk, js.jfnk, {"forcing": "kelley"})):
        with pytest.raises(ValueError) as et:
            t_fn(lambda x: x, z, z, **kw)
        with pytest.raises(ValueError) as ej:
            j_fn(lambda x: x, jnp.zeros(3), jnp.zeros(3), **kw)
        assert str(et.value) == str(ej.value)
