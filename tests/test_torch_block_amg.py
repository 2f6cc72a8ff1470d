"""``BlockDiaAmg`` of stormx_torch against the JAX package on the 32²
Poisson operator of ``tests/test_precond.py``, in float64.

The coarse hierarchy is the same host NumPy on both sides, so it must be
bit-exact.  One V-cycle agrees within 1e-12 (torch and XLA add the group
sums and the coarse product in other orders), and a CG + AMG history
within 1e-10 relative (plus 1e-13 of the initial residual at the tail, as
``tests/test_torch_krylov.py`` explains).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.precond import BlockDiaAmg as JAmg
from stormx.precond.block_amg import _coarsen_dia as j_coarsen
from stormx.precond.block_amg import prolong_repeat as j_prolong
from stormx.precond.block_amg import restrict_sum as j_restrict
from stormx.solvers import SolverOptions as JOptions
from stormx.solvers import cg as j_cg
from stormx.solvers import make_operator as j_make_operator
from stormx.sparse import formats as jf
from stormx_torch.precond import BlockDiaAmg
from stormx_torch.precond.block_amg import _coarsen_dia, prolong_repeat, restrict_sum
from stormx_torch.solvers import SolverOptions, cg, make_operator
from stormx_torch.sparse.formats import DIA


def _poisson(nx):
    """The Dirichlet 5-point operator of ``test_precond.py:510-526``."""
    n = nx * nx
    offs = (-nx, -1, 0, 1, nx)
    data = np.zeros((5, n))
    i = np.arange(n)
    data[2] = 4.0
    for k, off in enumerate(offs):
        if off == 0:
            continue
        j = i + off
        valid = (j >= 0) & (j < n)
        if abs(off) == 1:
            valid &= (i // nx) == (j // nx)
        data[k][valid] = -1.0
    return (DIA(data=torch.as_tensor(data), offsets=offs, shape=(n, n)),
            jf.DIA(data=jnp.asarray(data), offsets=offs, shape=(n, n)))


def test_coarsening_is_bit_exact():
    rng = np.random.default_rng(9)
    for n, g, offs in ((37, 4, (-5, -1, 0, 2)), (1024, 2, (-32, -1, 0, 1, 32))):
        data = rng.standard_normal((len(offs), n))
        got, want = _coarsen_dia(offs, data, n, g), j_coarsen(offs, data, n, g)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n,g", [(1000, 4), (4096, 8), (130, 2), (256, 128)])
def test_restrict_and_prolong_match_jax(n, g):
    rng = np.random.default_rng(7)
    nc = -(-n // g)
    r, e = rng.standard_normal(n), rng.standard_normal(nc)
    np.testing.assert_allclose(restrict_sum(torch.as_tensor(r), nc, g).numpy(),
                               np.asarray(j_restrict(jnp.asarray(r), nc, g)), rtol=1e-13)
    np.testing.assert_array_equal(prolong_repeat(torch.as_tensor(e), n, g).numpy(),
                                  np.asarray(j_prolong(jnp.asarray(e), n, g)))


@pytest.mark.parametrize("group,sweeps", [(2, 2), (4, 1)])
def test_levels_and_one_vcycle_match_jax(group, sweeps):
    t_dia, j_dia = _poisson(32)
    t = BlockDiaAmg(t_dia, group=group, num_sweeps=sweeps)
    j = JAmg(j_dia, group=group, num_sweeps=sweeps)
    assert len(t._levels) == len(j._levels)
    for lt, lj in zip(t._levels, j._levels):
        assert lt["op"].offsets == lj["op"].offsets and lt["nc"] == lj["nc"]
        np.testing.assert_array_equal(lt["op"].data.numpy(), np.asarray(lj["op"].data))
        np.testing.assert_array_equal(lt["inv_diag"].numpy(), np.asarray(lj["inv_diag"]))
    np.testing.assert_array_equal(t._coarse_inv.numpy(), np.asarray(j._coarse_inv))
    r = np.random.default_rng(1).standard_normal(t_dia.shape[0])
    want = np.asarray(j(jnp.asarray(r)))
    got = t(torch.as_tensor(r)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_symmetric():
    t_dia, _ = _poisson(32)
    amg = BlockDiaAmg(t_dia, group=2, num_sweeps=2)
    rng = np.random.default_rng(1)
    r1 = torch.as_tensor(rng.standard_normal(t_dia.shape[0]))
    r2 = torch.as_tensor(rng.standard_normal(t_dia.shape[0]))
    s1, s2 = float(torch.dot(amg(r1), r2)), float(torch.dot(r1, amg(r2)))
    assert abs(s1 - s2) <= 1e-10 * abs(s1)


def test_cg_with_amg_matches_jax():
    t_dia, j_dia = _poisson(32)
    n = t_dia.shape[0]
    b = np.random.default_rng(3).standard_normal(n)
    opts = dict(num_iterations=400, absolute_tolerance=0.0, relative_tolerance=1e-9)
    t = cg(make_operator(t_dia.matvec), torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
           precond=BlockDiaAmg(t_dia, group=2, num_sweeps=2), options=SolverOptions(**opts))
    j = j_cg(j_make_operator(j_dia.matvec), jnp.asarray(b), jnp.zeros(n),
             precond=JAmg(j_dia, group=2, num_sweeps=2), options=JOptions(**opts))
    assert t.converged and t.num_iterations == int(j.num_iterations)
    k = t.num_iterations
    hj = np.asarray(j.history)[: k + 1]
    np.testing.assert_allclose(t.history.numpy()[: k + 1], hj, rtol=1e-10, atol=1e-13 * hj[0])
    r = t_dia.matvec(t.x).numpy() - b
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("case", ["missing_diagonal", "group_1", "group_3"])
def test_validation_errors_match_jax(case):
    if case == "missing_diagonal":
        t_dia = DIA(data=torch.ones((1, 8), dtype=torch.float64), offsets=(1,), shape=(8, 8))
        j_dia = jf.DIA(data=jnp.ones((1, 8)), offsets=(1,), shape=(8, 8))
        kw = {}
    else:
        t_dia, j_dia = _poisson(8)
        kw = {"group": int(case[-1])}
    with pytest.raises(ValueError) as et:
        BlockDiaAmg(t_dia, **kw)
    with pytest.raises(ValueError) as ej:
        JAmg(j_dia, **kw)
    # The same test, the same words (the port names the JAX package's lane
    # width as the reason for the divisor rule).
    key = {"missing_diagonal": "diagonal", "group_1": "≥ 2", "group_3": "divide 128"}[case]
    assert key in str(et.value) and key in str(ej.value)


def test_levels_follow_dtype_and_device():
    t_dia, _ = _poisson(32)
    amg = BlockDiaAmg(t_dia, group=4, dtype=torch.float32)
    assert all(lv["op"].data.dtype == torch.float32 for lv in amg._levels)
    assert amg._coarse_inv.dtype == torch.float32
    assert amg(torch.ones(t_dia.shape[0], dtype=torch.float32)).dtype == torch.float32
