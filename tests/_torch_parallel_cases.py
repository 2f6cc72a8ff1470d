"""Shared inputs of the distributed-layer parity tests
(``tests/test_torch_parallel*.py``): the operators of ``tests/test_parallel.py``
made in both packages from the same NumPy arrays, and thread ranks on the
CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from stormx.sparse import CSR as JCSR
from stormx_torch.parallel.comm import run_thread_ranks
from stormx_torch.sparse.formats import CSR as TCSR

from conftest import make_nonsym_matrix, make_spd_matrix

# Each collective waits at most this long, and the ranks' threads are
# joined within twice it, so ranks that part ways fail a test instead of
# hanging the run.
RANK_TIMEOUT = 30.0


def ranks(num_parts, fn, timeout=RANK_TIMEOUT):
    """``fn(mesh)`` on ``num_parts`` CPU thread ranks over gloo."""
    return run_thread_ranks(num_parts, fn, device="cpu", timeout=timeout)


def triples(a):
    """CSR triples of a dense matrix (row-major nonzeros)."""
    rows, cols = np.nonzero(a)
    rp = np.zeros(a.shape[0] + 1, dtype=np.int32)
    np.add.at(rp, rows + 1, 1)
    return a[rows, cols], cols.astype(np.int32), np.cumsum(rp).astype(np.int32)


def csr_pair(a):
    """The same CSR in both packages (the port's on the CPU)."""
    data, cols, rp = triples(a)
    n = a.shape[0]
    return (JCSR(data=jnp.asarray(data), indices=jnp.asarray(cols), row_ptr=jnp.asarray(rp),
                 shape=(n, n)),
            TCSR(data=torch.as_tensor(data), indices=torch.as_tensor(cols),
                 row_ptr=torch.as_tensor(rp), shape=(n, n)))


def spd_problem():
    """``tests/test_parallel.py``'s ``spd_problem``: n = 96, SPD."""
    rng = np.random.default_rng(7)
    n = 96
    a = make_spd_matrix(n, rng, density=0.06)
    a[np.abs(a) < 1e-12] = 0.0
    b = rng.standard_normal(n)
    return a, b


def nonsym_problem():
    """``test_sharded_nonsymmetric_solvers``'s operator: n = 64."""
    rng = np.random.default_rng(11)
    n = 64
    a = make_nonsym_matrix(n, rng)
    a[(np.abs(a) < 0.4) & ~np.eye(n, dtype=bool)] = 0.0
    b = rng.standard_normal(n)
    return a, b


def poisson(nx=16):
    """The Dirichlet 5-point operator of ``TestShardedPreconditioner``, as a
    dense matrix, and its right-hand side."""
    n = nx * nx
    a = 4.0 * np.eye(n)
    idx = np.arange(n)
    i, j = idx // nx, idx % nx
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ii, jj = i + di, j + dj
        m = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < nx)
        a[idx[m], (ii * nx + jj)[m]] = -1.0
    return a, np.random.default_rng(5).standard_normal(n)


def np_(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def assert_same_ranks(results):
    """Every rank returned the same iterations, convergence flag, history
    and x, bit for bit."""
    first = results[0]
    for res in results[1:]:
        assert res.num_iterations == first.num_iterations
        assert res.converged == first.converged
        np.testing.assert_array_equal(np_(res.history), np_(first.history))
        np.testing.assert_array_equal(np_(res.x), np_(first.x))


def assert_history(port, jax_res, rtol=1e-10):
    """Equal iteration counts and histories within ``rtol``."""
    k = int(jax_res.num_iterations)
    assert port.num_iterations == k
    np.testing.assert_allclose(np_(port.history)[: k + 1], np.asarray(jax_res.history)[: k + 1],
                               rtol=rtol)
