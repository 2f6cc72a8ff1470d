"""The distributed banded (DIA) and windowed (SlicedELL) operators of
stormx_torch against the JAX package's, on the same NumPy-made inputs, with
CPU thread ranks over gloo (``tests/test_torch_parallel.py`` says how).

Tolerances: partition arrays bit-equal (the sliced ELL arrays after the
(R, K) → (K, R) transpose); the DIA product bit-exact against the serial
``DIA.matvec`` (both add the diagonals in order from zero) and within 1e-15
of the JAX product; the dense-window sliced product within 1e-12 of the ELL
oracle; every overlapped product bit-identical to the plain one; float64
histories within 1e-10 relative with equal iterations.  The float32 sliced
path in mode ``"pallas"`` (here K1's plain version) agrees with the JAX
``"pallas"`` mode (its Pallas kernel in interpret mode) within 2e-6·max|y|,
the bound the JAX test holds its kernel to against the dense mode, and
solves within 2 iterations of it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.parallel as jpar
from stormx.fvm.divgrad import assemble_laplacian as j_laplacian
from stormx.mesh import structured_tri_rect as j_rect
from stormx.parallel import sliced as jsl
from stormx.solvers import SolverOptions as JOptions
from stormx.sparse import DIA as JDIA
from stormx_torch import parallel as tpar
from stormx_torch.interop import partitioned_dia_from_fields, partitioned_sliced_from_fields
from stormx_torch.ops import sell_spmv
from stormx_torch.parallel import sliced as tsl
from stormx_torch.solvers import SolverOptions, make_operator, solve
from stormx_torch.sparse.formats import CSR as TCSR, DIA as TDIA

from _torch_parallel_cases import assert_history, assert_same_ranks, np_, ranks

CPU = dict(device="cpu")


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name)) if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _poisson_dia(nx):
    """``TestBandedDistributed._poisson_dia``: the 5-point operator as DIA."""
    n = nx * nx
    i, j = np.arange(n) // nx, np.arange(n) % nx
    data = np.zeros((5, n))
    data[0] = np.where(i > 0, -1.0, 0.0)
    data[1] = np.where(j > 0, -1.0, 0.0)
    data[2] = 4.0
    data[3] = np.where(j < nx - 1, -1.0, 0.0)
    data[4] = np.where(i < nx - 1, -1.0, 0.0)
    offsets = (-nx, -1, 0, 1, nx)
    return (JDIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n)),
            TDIA(data=torch.as_tensor(data), offsets=offsets, shape=(n, n)))


def _csr_pair(csr, dtype=np.float64, shift=0.1):
    """A JAX mesh CSR and the port's copy, the diagonal shifted by ``shift``
    off the constant nullspace, in ``dtype``."""
    from stormx.sparse import CSR as JCSR

    rp, idx = np.array(csr.row_ptr), np.array(csr.indices)
    data = np.asarray(csr.data).astype(dtype)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(rp))
    data[idx == rows] += dtype(shift)
    return (JCSR(data=jnp.asarray(data), indices=jnp.asarray(idx), row_ptr=jnp.asarray(rp),
                 shape=csr.shape),
            TCSR(data=torch.as_tensor(data), indices=torch.as_tensor(idx),
                 row_ptr=torch.as_tensor(rp), shape=csr.shape))


@pytest.fixture(scope="module")
def mesh_csr():
    """``TestSlicedDistributed``'s operator: the 286-cell Laplacian + 0.1·I."""
    return _csr_pair(j_laplacian(j_rect(13, 11)).to_csr())


@pytest.fixture(scope="module")
def f32_csr():
    """``TestSlicedPallasDistributed``'s float32 operator (2,560 cells)."""
    return _csr_pair(j_laplacian(j_rect(40, 32)).to_csr(), dtype=np.float32)


# -- DIA ---------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_partition_dia_matches_jax(p):
    jd, td = _poisson_dia(16)
    jp, tp = jpar.partition_dia(jd, p), tpar.partition_dia(td, p, **CPU)
    assert (tp.num_parts, tp.n_global, tp.n_loc, tp.h, tp.offsets) == (
        jp.num_parts, jp.n_global, jp.n_loc, jp.h, tuple(jp.offsets))
    np.testing.assert_array_equal(np_(tp.data), np.asarray(jp.data))
    carried = partitioned_dia_from_fields(_fields(jp), **CPU)
    np.testing.assert_array_equal(np_(carried.data), np_(tp.data))
    assert carried.offsets == tp.offsets and carried.h == tp.h


def test_partition_dia_halo_too_wide_raises():
    _, td = _poisson_dia(16)  # h = 16, n_loc at P = 32 would be 8
    with pytest.raises(ValueError, match="halo"):
        tpar.partition_dia(td, 32, **CPU)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_dia_matvec_exact_and_overlap_identical(p):
    """Bit-exact against the serial product, overlapped or not; within
    1e-15 of the JAX sharded product (XLA may fuse the multiply-adds)."""
    from jax.sharding import PartitionSpec as PS

    import jax

    jd, td = _poisson_dia(16)
    n = td.shape[0]
    tp = tpar.partition_dia(td, p, **CPU)
    x = np.random.default_rng(0).standard_normal(n)
    xp = np.zeros(p * tp.n_loc)
    xp[:n] = x
    xp = torch.as_tensor(xp.reshape(p, -1))

    def run(mesh):
        return {ov: tp.local_matvec(mesh, overlap=ov)(xp[mesh.rank]) for ov in (False, True)}

    outs = ranks(p, run)
    y = {ov: torch.cat([o[ov] for o in outs])[:n] for ov in (False, True)}
    np.testing.assert_array_equal(np_(y[True]), np_(y[False]))
    np.testing.assert_array_equal(np_(y[True]), np_(td.matvec(torch.as_tensor(x))))
    jp = jpar.partition_dia(jd, p)
    local = jp.local_matvec("parts")
    mv = jax.jit(jax.shard_map(lambda xl, dl: local(xl[0], dl[0])[None],
                               mesh=jpar.make_device_mesh(p), in_specs=(PS("parts"), PS("parts")),
                               out_specs=PS("parts")))
    yj = np.asarray(mv(jnp.asarray(np_(xp)), jp.data)).reshape(-1)[:n]
    np.testing.assert_allclose(np_(y[True]), yj, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("p", [2, 8])
def test_sharded_dia_cg_matches_jax_and_serial(p):
    jd, td = _poisson_dia(16)
    b = np.ones(td.shape[0])
    tp = tpar.partition_dia(td, p, **CPU)
    outs = ranks(p, lambda mesh: tpar.sharded_dia_solve(tp, b, mesh=mesh, method="cg"))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged
    serial = solve(make_operator(td.matvec), torch.as_tensor(b), method="cg")
    assert_history(res, serial)
    jres = jpar.sharded_dia_solve(jpar.partition_dia(jd, p), b, mesh=jpar.make_device_mesh(p),
                                  method="cg")
    assert_history(res, jres)
    np.testing.assert_allclose(np_(res.x), np.asarray(jres.x), rtol=1e-9)


def test_sharded_dia_jacobi_and_gmres():
    """Jacobi through ``precond_diag`` and GMRES (CGS2 default) at P = 4,
    each against the JAX package."""
    jd, td = _poisson_dia(16)
    b = np.random.default_rng(4).standard_normal(td.shape[0])
    diag = np.full(td.shape[0], 4.0)
    tp, jp = tpar.partition_dia(td, 4, **CPU), jpar.partition_dia(jd, 4)
    jmesh = jpar.make_device_mesh(4)
    for kw in (dict(method="cg", precond_diag=diag), dict(method="gmres")):
        res = ranks(4, lambda mesh, kw=kw: tpar.sharded_dia_solve(tp, b, mesh=mesh, **kw))[0]
        assert res.converged
        assert_history(res, jpar.sharded_dia_solve(jp, b, mesh=jmesh, **kw))


# -- SlicedELL -----------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
def test_partition_sliced_dense_matches_jax(mesh_csr, p):
    jcsr, tcsr = mesh_csr
    jp = jpar.partition_sliced(jcsr, p)
    tp = tpar.partition_sliced(tcsr, p, **CPU)
    assert tp.mode == jp.mode == "dense"
    for name in ("n_global", "n_loc", "pad_lo", "window", "block_rows", "h_lo", "h_hi"):
        assert getattr(tp, name) == getattr(jp, name), name
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(np_(tp.dense_blocks), np.asarray(jp.dense_blocks))
    carried = partitioned_sliced_from_fields(_fields(jp), **CPU)
    np.testing.assert_array_equal(np_(carried.dense_blocks), np_(tp.dense_blocks))


@pytest.mark.parametrize("p", [2, 4])
def test_partition_sliced_pallas_matches_jax(f32_csr, p):
    jcsr, tcsr = f32_csr
    jp = jpar.partition_sliced(jcsr, p, mode="pallas", block_rows=128)
    tp = tpar.partition_sliced(tcsr, p, mode="pallas", block_rows=128, **CPU)
    assert tp.dense_blocks is None and tp.ell_data.dtype == torch.float32
    np.testing.assert_array_equal(tp.perm, jp.perm)
    for name in ("ell_data", "ell_cols"):
        np.testing.assert_array_equal(np_(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)).transpose(0, 1, 3, 2))
    carried = partitioned_sliced_from_fields(_fields(jp), **CPU)
    for name in ("ell_data", "ell_cols"):
        np.testing.assert_array_equal(np_(getattr(carried, name)), np_(getattr(tp, name)))
        assert getattr(carried, name).is_contiguous()
    assert tpar.partition_sliced(tcsr, p, **CPU).mode == "dense"  # "auto" off the card
    with pytest.raises(ValueError, match="block_rows"):
        tpar.partition_sliced(tcsr, p, mode="pallas", block_rows=96, **CPU)
    with pytest.raises(ValueError, match="float32"):
        tpar.partition_sliced(_csr_pair(j_laplacian(j_rect(8, 8)).to_csr())[1], 2,
                              mode="pallas", **CPU)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sliced_matvec_matches_oracle_and_overlap(mesh_csr, p):
    jcsr, tcsr = mesh_csr
    n = tcsr.shape[0]
    tp = tpar.partition_sliced(tcsr, p, **CPU)
    x = np.random.default_rng(0).standard_normal(n)
    xp = tsl._partition_vec(tp, torch.as_tensor(x))

    def run(mesh):
        return {ov: tp.local_matvec(mesh, overlap=ov)(xp[mesh.rank]) for ov in (False, True)}

    outs = ranks(p, run)
    y = {ov: tsl._unpartition_vec(tp, torch.stack([o[ov] for o in outs])) for ov in (False, True)}
    np.testing.assert_array_equal(np_(y[True]), np_(y[False]))
    np.testing.assert_allclose(np_(y[True]), np_(tcsr.matvec(torch.as_tensor(x))), atol=1e-12)


def test_sliced_pallas_mode_matches_jax_pallas(f32_csr, monkeypatch):
    """Mode ``"pallas"`` at R = 128 and P = 4: K1 (its plain version here)
    per slab against the JAX ``"pallas"`` mode in interpret mode, and the
    launches per product: three with ``overlap`` (interior, head, tail),
    one without."""
    from jax.sharding import PartitionSpec as PS

    import jax

    jcsr, tcsr = f32_csr
    n = tcsr.shape[0]
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    tp = tpar.partition_sliced(tcsr, 4, mode="pallas", block_rows=128, **CPU)
    calls = []
    plain = sell_spmv.sell_spmv

    def counted(sell, v):
        calls.append(sell.data.shape[0])
        return plain(sell, v)

    monkeypatch.setattr(sell_spmv, "sell_spmv", counted)
    xp = tsl._partition_vec(tp, torch.as_tensor(x))

    def run(mesh):
        return {ov: tp.local_matvec(mesh, overlap=ov)(xp[mesh.rank]) for ov in (True, False)}

    outs = ranks(4, run)
    nbl = tp.n_loc // tp.block_rows
    assert len(calls) == 4 * (3 + 1) and sorted(calls)[-4:] == [nbl] * 4
    y = {ov: tsl._unpartition_vec(tp, torch.stack([o[ov] for o in outs])) for ov in (False, True)}
    np.testing.assert_array_equal(np_(y[True]), np_(y[False]))

    jp = jpar.partition_sliced(jcsr, 4, mode="pallas", block_rows=128)
    local = jp.local_matvec("parts")
    mv = jax.jit(jax.shard_map(
        lambda xl, *ops: local(xl[0], *(o[0] for o in ops))[None],
        mesh=jpar.make_device_mesh(4), in_specs=tuple([PS("parts")] * 3),
        out_specs=PS("parts"), check_vma=False))
    yj = np.asarray(jsl._unpartition_vec(
        jp, mv(jsl._partition_vec(jp, jnp.asarray(x)), *jp.op_arrays())))
    np.testing.assert_allclose(np_(y[True]), yj, atol=2e-6 * np.abs(yj).max())


def test_sliced_pallas_solve_matches_jax_pallas(f32_csr):
    jcsr, tcsr = f32_csr
    b = np.random.default_rng(0).standard_normal(tcsr.shape[0]).astype(np.float32)
    opts = dict(num_iterations=400, absolute_tolerance=0.0, relative_tolerance=1e-5)
    tp = tpar.partition_sliced(tcsr, 4, mode="pallas", block_rows=128, **CPU)
    outs = ranks(4, lambda mesh: tpar.sharded_sliced_solve(
        tp, b, mesh=mesh, options=SolverOptions(**opts)))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged and res.x.dtype == torch.float32
    jp = jpar.partition_sliced(jcsr, 4, mode="pallas", block_rows=128)
    jres = jpar.sharded_sliced_solve(jp, b, mesh=jpar.make_device_mesh(4),
                                     options=JOptions(**opts))
    assert abs(res.num_iterations - int(jres.num_iterations)) <= 2
    xj = np.asarray(jres.x)
    np.testing.assert_allclose(np_(res.x), xj, atol=5e-5 * np.abs(xj).max())


@pytest.mark.parametrize("p", [1, 4, 8])
def test_sharded_sliced_cg_matches_jax_and_serial(mesh_csr, p):
    jcsr, tcsr = mesh_csr
    b = np.random.default_rng(0).standard_normal(tcsr.shape[0])
    opts = dict(num_iterations=500, absolute_tolerance=1e-10, relative_tolerance=1e-10)
    tp = tpar.partition_sliced(tcsr, p, **CPU)
    outs = ranks(p, lambda mesh: tpar.sharded_sliced_solve(
        tp, b, mesh=mesh, method="cg", options=SolverOptions(**opts)))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged
    serial = solve(make_operator(tcsr.matvec), torch.as_tensor(b), method="cg",
                   options=SolverOptions(**opts))
    assert_history(res, serial)
    jres = jpar.sharded_sliced_solve(jpar.partition_sliced(jcsr, p), b,
                                     mesh=jpar.make_device_mesh(p), method="cg",
                                     options=JOptions(**opts))
    assert_history(res, jres)


def test_sharded_dia_solve_refuses_block_amg():
    _, td = _poisson_dia(8)
    tp = tpar.partition_dia(td, 1, **CPU)
    with pytest.raises(NotImplementedError, match="DistributedBlockDiaAmg"):
        ranks(1, lambda mesh: tpar.sharded_dia_solve(tp, np.ones(64), mesh=mesh, amg=object()))
