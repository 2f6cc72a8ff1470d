"""The distributed CSR layer of stormx_torch (``partition_csr``,
``PartitionedOperator``, ``sharded_matvec``, ``sharded_solve``, the BFS
partitioner and the mesh handle) against the JAX package's, on the same
NumPy-made inputs.

Ranks are threads of this process over gloo on the CPU
(``run_thread_ranks``); the JAX side runs on ``tests/conftest.py``'s 8
virtual CPU devices, as ``tests/test_parallel.py`` does.  Every collective
waits at most ``RANK_TIMEOUT`` seconds and the ranks are joined within twice
that, so a divergence fails instead of hanging.

Tolerances: partition layouts (``perm``, ``fill_slots``, the halo tables,
the BFS parts) are host NumPy and bit-equal; products within 1e-12 of the
dense product (torch and XLA sum rows in other orders) and the overlapped
product bit-identical to the plain one; float64 histories within 1e-10
relative with equal iterations (gloo's and XLA's ``psum`` add the partial
dots in other orders); every rank returns the same result bit for bit.
"""

import time

import numpy as np
import pytest
import torch

import stormx.parallel as jpar
from stormx.solvers import make_operator as jmake_operator, solve as jsolve
from stormx_torch import parallel as tpar
from stormx_torch.parallel.comm import RankPool
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import vector as tv
from stormx_torch.solvers import make_operator, solve

from _torch_parallel_cases import (assert_history, assert_same_ranks, csr_pair, np_,
                                   nonsym_problem, ranks, spd_problem)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def spd():
    a, b = spd_problem()
    jcsr, tcsr = csr_pair(a)
    return a, b, jcsr, tcsr


def _grid_edges(nx):
    n = nx * nx
    idx = np.arange(n)
    i, j = idx // nx, idx % nx
    r = np.concatenate([idx[i < nx - 1], idx[j < nx - 1]])
    c = np.concatenate([idx[i < nx - 1] + nx, idx[j < nx - 1] + 1])
    return n, r, c


def test_native_bfs_matches_python_and_jax():
    from stormx.parallel.partition import _bfs_partition_python as jbfs
    from stormx_torch._native import native_bfs_partition
    from stormx_torch.parallel.partition import _bfs_partition_python, _csr_adjacency

    rng = np.random.default_rng(13)
    n = 120
    rows, cols = rng.integers(0, n, 500), rng.integers(0, n, 500)
    ptr, c, deg = _csr_adjacency(n, rows, cols)
    for k in (2, 3, 8):
        native = native_bfs_partition(ptr, c, k)
        assert native is not None
        np.testing.assert_array_equal(native, _bfs_partition_python(n, ptr, c, deg, k))
        np.testing.assert_array_equal(native, jbfs(n, ptr, c, deg, k))


def test_bfs_partition_matches_jax_and_is_balanced():
    n, r, c = _grid_edges(16)
    part = tpar.bfs_partition(n, r, c, 4)
    np.testing.assert_array_equal(part, jpar.bfs_partition(n, r, c, 4))
    sizes = np.bincount(part, minlength=4)
    assert sizes.max() <= -(-n // 4) and sizes.min() >= n // 4 - 1
    assert int(np.sum(part[r] != part[c])) < len(r) // 4


@pytest.mark.parametrize("method", ["rcm-blocks", "bfs"])
@pytest.mark.parametrize("num_parts", [1, 2, 4, 8])
def test_partition_csr_arrays_match_jax(spd, num_parts, method):
    _, _, jcsr, tcsr = spd
    jp = jpar.partition_csr(jcsr, num_parts, method=method)
    tp = tpar.partition_csr(tcsr, num_parts, method=method, **CPU)
    assert (tp.num_parts, tp.n_global, tp.n_pad, tp.s_max) == (
        jp.num_parts, jp.n_global, jp.n_pad, jp.s_max)
    for name in ("data", "cols", "send_slots", "perm", "fill_slots",
                 "bnd_idx", "bnd_data", "bnd_cols"):
        np.testing.assert_array_equal(np_(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                      err_msg=name)


def test_partition_vector_roundtrip_matches_jax(spd):
    _, b, jcsr, tcsr = spd
    tp = tpar.partition_csr(tcsr, 4, method="bfs", **CPU)
    jp = jpar.partition_csr(jcsr, 4, method="bfs")
    xp = tpar.partition_vector(tp, b)
    np.testing.assert_array_equal(np_(xp), np.asarray(jpar.partition_vector(jp, b)))
    np.testing.assert_array_equal(np_(tpar.unpartition_vector(tp, xp)), b)


@pytest.mark.parametrize("method", ["rcm-blocks", "bfs"])
@pytest.mark.parametrize("num_parts", [1, 2, 4, 8])
def test_sharded_matvec_matches_dense_and_jax(spd, num_parts, method):
    """Against the dense product (1e-12) and the JAX ``sharded_matvec``
    (1e-14 relative); ``overlap`` bit-identical to the plain product."""
    a, _, jcsr, tcsr = spd
    x = np.random.default_rng(1).standard_normal(a.shape[0])
    tp = tpar.partition_csr(tcsr, num_parts, method=method, **CPU)
    jp = jpar.partition_csr(jcsr, num_parts, method=method)
    xp = tpar.partition_vector(tp, x)

    def run(mesh):
        return {ov: tpar.sharded_matvec(tp, mesh, overlap=ov)(xp) for ov in (False, True)}

    outs = ranks(num_parts, run)
    for out in outs:
        np.testing.assert_array_equal(np_(out[True]), np_(out[False]))
        np.testing.assert_array_equal(np_(out[True]), np_(outs[0][True]))
    y = np_(tpar.unpartition_vector(tp, outs[0][True]))
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-10)
    yj = np.asarray(jpar.sharded_matvec(jp, jpar.make_device_mesh(num_parts))(
        jpar.partition_vector(jp, x)))
    np.testing.assert_allclose(np_(outs[0][True]), yj, rtol=1e-14, atol=1e-13)


@pytest.mark.parametrize("method", ["rcm-blocks", "bfs"])
@pytest.mark.parametrize("num_parts", [2, 4, 8])
def test_sharded_cg_matches_jax_and_serial(spd, num_parts, method):
    a, b, jcsr, tcsr = spd
    tp = tpar.partition_csr(tcsr, num_parts, method=method, **CPU)
    outs = ranks(num_parts, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh, method="cg"))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged
    jres = jpar.sharded_solve(jpar.partition_csr(jcsr, num_parts, method=method), b,
                              method="cg")
    assert_history(res, jres)
    serial = solve(make_operator(tcsr.matvec), torch.as_tensor(b), method="cg")
    assert_history(res, serial)
    np.testing.assert_allclose(np_(res.x), np.linalg.solve(a, b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "tfqmr", "idrs", "lgmres", "cgs"])
def test_sharded_nonsymmetric_solvers(method):
    """Every method of ``tests/test_parallel.py::test_sharded_nonsymmetric_
    solvers`` at P = 4: converged to the dense solution, iterations and
    history equal to the JAX package's (GMRES family with the distributed
    CGS2 default, IDR(s) with the shadow basis drawn in global layout)."""
    a, b = nonsym_problem()
    jcsr, tcsr = csr_pair(a)
    tp = tpar.partition_csr(tcsr, 4, **CPU)
    outs = ranks(4, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh, method=method))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged
    np.testing.assert_allclose(np_(res.x), np.linalg.solve(a, b), rtol=1e-4, atol=1e-5)
    jres = jpar.sharded_solve(jpar.partition_csr(jcsr, 4), b, method=method)
    assert_history(res, jres)


def test_partition_invariance_across_counts(spd):
    _, b, _, tcsr = spd
    hist = {}
    for p in (2, 8):
        tp = tpar.partition_csr(tcsr, p, **CPU)
        res = ranks(p, lambda mesh, tp=tp: tpar.sharded_solve(tp, b, mesh=mesh))[0]
        h = np_(res.history)
        hist[p] = h[~np.isnan(h)]
    assert len(hist[2]) == len(hist[8])
    np.testing.assert_allclose(hist[2], hist[8], rtol=1e-10)


def test_overlap_solves_agree(spd):
    """Whole CG solves with and without the overlapped product: the
    products are bit-identical, so the histories are too."""
    _, b, _, tcsr = spd
    from stormx_torch.solvers import SolverOptions

    opts = SolverOptions(num_iterations=40, absolute_tolerance=0.0, relative_tolerance=0.0)
    tp = tpar.partition_csr(tcsr, 4, **CPU)
    outs = ranks(4, lambda mesh: [tpar.sharded_solve(tp, b, mesh=mesh, options=opts,
                                                     overlap=ov) for ov in (False, True)])
    r0, r1 = outs[0]
    np.testing.assert_array_equal(np_(r1.history), np_(r0.history))
    np.testing.assert_array_equal(np_(r1.x), np_(r0.x))


def test_vector_reductions_over_ranks():
    """``ops.vector``'s reductions with the mesh handle as ``axis_name``
    equal the reductions of the whole vector (1e-13)."""
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(30), rng.standard_normal(30)
    stack = rng.standard_normal((4, 30))
    parts = np.array_split(np.arange(30), 3)

    def run(mesh):
        i = torch.as_tensor(parts[mesh.rank])
        tx, ty = torch.as_tensor(x)[i], torch.as_tensor(y)[i]
        return [tv.dot(tx, ty, axis_name=mesh), tv.norm_1(tx, axis_name=mesh),
                tv.norm_2(tx, axis_name=mesh), tv.norm_inf(tx, axis_name=mesh),
                tv.norm_p(tx, 3, axis_name=mesh),
                tv.dots_stacked(torch.as_tensor(stack)[:, i], tx, axis_name=mesh)]

    outs = ranks(3, run)
    want = [x @ y, np.abs(x).sum(), np.linalg.norm(x), np.abs(x).max(),
            (np.abs(x) ** 3).sum() ** (1 / 3), stack @ x]
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(np_(got), w, rtol=1e-13)
    for out in outs[1:]:
        for got, first in zip(out, outs[0]):
            np.testing.assert_array_equal(np_(got), np_(first))
    zx = torch.as_tensor(x + 1j * y)
    got = ranks(2, lambda mesh: tv.dot(zx[mesh.rank::2], zx[mesh.rank::2], axis_name=mesh))
    np.testing.assert_allclose(complex(got[0]), np.vdot(x + 1j * y, x + 1j * y), rtol=1e-13)


def test_exchange_shifts_with_zero_ends():
    """``RankMesh.exchange`` is ``ppermute``'s two shifts: the first rank
    gets zeros from before, the last from after; widths may differ."""
    def run(mesh):
        r = float(mesh.rank)
        return mesh.exchange(torch.full((3,), r), torch.full((2,), 10 + r))

    outs = ranks(4, run)
    for r, (from_prev, from_next) in enumerate(outs):
        assert np_(from_prev).tolist() == ([0.0] * 3 if r == 0 else [r - 1.0] * 3)
        assert np_(from_next).tolist() == ([0.0] * 2 if r == 3 else [11.0 + r] * 2)


def test_a_rank_that_raises_fails_fast():
    """One rank raises before its first collective: the others time out in
    it, and the caller gets the first rank's error, not a hang."""
    def run(mesh):
        if mesh.rank == 1:
            raise ValueError("rank 1 failed")
        return mesh.all_reduce_sum(torch.ones(1))

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 failed"):
        ranks(3, run, timeout=2.0)
    assert time.monotonic() - t0 < 10.0


def test_process_ranks_match_thread_ranks(spd):
    """``RankPool``'s process ranks (the way ranks share a card) give the
    thread ranks' CG bit for bit, take several jobs, and hand back a rank's
    error as ``StormError`` with its traceback."""
    from _torch_rank_jobs import fail_on_rank_one, sharded_cg

    _, b, _, tcsr = spd
    tp = tpar.partition_csr(tcsr, 2, **CPU)
    threads = ranks(2, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh))
    # The first job waits up to 2 × timeout for the ranks to start, import
    # torch and join the group: ~3 s on an idle host, 11–18 s on a loaded
    # one.  The failing job waits one timeout on rank 0's all-reduce.
    with RankPool(2, device="cpu", timeout=15.0) as pool:
        procs = pool.run(sharded_cg, tp, b)
        again = pool.run(sharded_cg, tp, b)
        with pytest.raises(StormError, match="rank 1 failed"):
            pool.run(fail_on_rank_one)
    for (its, hist, x), (its2, _, x2), t in zip(procs, again, threads):
        assert its == its2 == t.num_iterations
        np.testing.assert_array_equal(hist, np_(t.history))
        np.testing.assert_array_equal(x, np_(t.x))
        np.testing.assert_array_equal(x2, x)


def test_mesh_handle_checks(spd):
    _, b, _, tcsr = spd
    tp = tpar.partition_csr(tcsr, 2, **CPU)
    with pytest.raises(StormError, match="init_process_group"):
        tpar.make_device_mesh(2, device="cpu")
    with pytest.raises(StormError, match="2 parts"):
        ranks(3, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh))
    with pytest.raises(StormError, match="make_device_mesh"):
        tv.dot(torch.ones(2), torch.ones(2), axis_name="parts")
    with pytest.raises(StormError, match="num_parts"):
        ranks(2, lambda mesh: tpar.make_device_mesh(3, group=mesh.group, device="cpu"))
    meshes = ranks(2, lambda mesh: tpar.make_device_mesh(2, group=mesh.group, device="cpu"))
    assert [m.rank for m in meshes] == [0, 1] and meshes[0].backend == "gloo"


def test_partitioned_operator_from_fields(spd):
    """The JAX operator carried across by its fields solves as the port's
    own partition does."""
    import dataclasses

    from stormx_torch.interop import partitioned_operator_from_fields

    _, b, jcsr, tcsr = spd
    jp = jpar.partition_csr(jcsr, 4, method="bfs")
    fields = {f.name: (np.asarray(getattr(jp, f.name)) if hasattr(getattr(jp, f.name), "shape")
                       else getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    tp = partitioned_operator_from_fields(fields, **CPU)
    own = tpar.partition_csr(tcsr, 4, method="bfs", **CPU)
    for f in dataclasses.fields(own):
        np.testing.assert_array_equal(np_(getattr(tp, f.name)), np_(getattr(own, f.name)))
    res = ranks(4, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh))[0]
    assert_history(res, jpar.sharded_solve(jp, b))


def test_serial_reference_history_matches_jax(spd):
    """The serial oracle of the tests above is itself the JAX serial
    history (1e-10)."""
    _, b, jcsr, tcsr = spd
    serial = solve(make_operator(tcsr.matvec), torch.as_tensor(b), method="cg")
    import jax.numpy as jnp

    assert_history(serial, jsolve(jmake_operator(jcsr.matvec), jnp.asarray(b), method="cg"))
