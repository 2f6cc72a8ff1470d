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


def poisson_dia(nx, coupling_y=1.0):
    """``tests/test_distributed_amg.py``'s ``_poisson_dia``: the 5-point
    operator with row-aligned zero-outside-band diagonals, as a DIA in both
    packages (the port's on the CPU)."""
    from stormx.sparse.formats import DIA as JDIA
    from stormx_torch.sparse.formats import DIA as TDIA

    n = nx * nx
    offs = (-nx, -1, 0, 1, nx)
    data = np.zeros((5, n))
    i = np.arange(n)
    data[2] = 2.0 + 2.0 * coupling_y
    for k, off in enumerate(offs):
        if off == 0:
            continue
        j = i + off
        valid = (j >= 0) & (j < n)
        if abs(off) == 1:
            valid &= (i // nx) == (j // nx)
        data[k][valid] = -1.0 if abs(off) == 1 else -coupling_y
    return (JDIA(data=jnp.asarray(data), offsets=offs, shape=(n, n)),
            TDIA(data=torch.as_tensor(data), offsets=offs, shape=(n, n)))


NV = 4  # tests/test_config3_bsr.py's variables per cell


def config3_bsr(box=(5, 4, 3)):
    """``tests/test_config3_bsr.py``'s ``tet_problem``: A = L ⊗ B + I ⊗ C on
    a tetrahedral box, NV = 4, as a BSR in both packages, and its b."""
    from stormx.fvm.divgrad import assemble_laplacian
    from stormx.mesh import structured_tet_box
    from stormx.sparse import BSR as JBSR
    from stormx_torch.sparse.formats import BSR as TBSR

    mesh = structured_tet_box(*box)
    L = assemble_laplacian(mesh)
    n = mesh.num_cells
    data, cols = np.array(L.data), np.array(L.cols)
    rng = np.random.default_rng(3)
    B = np.eye(NV) + 0.2 * np.ones((NV, NV))
    C = 6.0 * np.eye(NV) + 0.8 * np.triu(rng.standard_normal((NV, NV)), 1)
    blocks = data[:, :, None, None] * B[None, None]
    blocks += ((cols == np.arange(n)[:, None]) & (data != 0))[..., None, None] * C
    b = rng.standard_normal(n * NV)
    shape = (n * NV, n * NV)
    return (JBSR(blocks=jnp.asarray(blocks), cols=jnp.asarray(cols), shape=shape),
            TBSR(blocks=torch.as_tensor(blocks), cols=torch.as_tensor(cols), shape=shape), b)


def tri_mesh_pair(nx, ny):
    """``__graft_entry__._structured_tri_mesh(nx, ny)`` (2·nx·ny triangles)
    in both packages, from the same nodes and cells."""
    import __graft_entry__ as g
    from stormx_torch.mesh import build_mesh

    jm = g._structured_tri_mesh(nx, ny)
    return jm, build_mesh(jm.node_positions, jm.cell_nodes)


def taylor_green(xy):
    """``tests/test_navier_stokes.py``'s Taylor–Green field plus a removable
    gradient pollution, at cell centres ``xy``."""
    x, y = xy[:, 0], xy[:, 1]
    u = np.sin(np.pi * x) * np.cos(np.pi * y)
    v = -np.cos(np.pi * x) * np.sin(np.pi * y)
    gx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    gy = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return np.stack([u + gx, v + gy], axis=1)


def index_gathers(monkeypatch):
    """Make every ``PartitionedFv.local_mesh`` gather ``x[idx]`` by tensor
    indexing on the plan's own index map, to hold K3's plans against."""
    from types import SimpleNamespace

    from stormx_torch.parallel.fvm import _PLANS, PartitionedFv

    plain = PartitionedFv.local_mesh

    def indexed(self, rank, device, dtype):
        lm = SimpleNamespace(**vars(plain(self, rank, device, dtype)))
        for attr, table, _ in _PLANS:
            idx = torch.as_tensor(getattr(self, table)[rank].reshape(-1).astype(np.int64),
                                  device=device)
            setattr(lm, attr, lambda x, idx=idx: x[idx])
        return lm

    monkeypatch.setattr(PartitionedFv, "local_mesh", indexed)
