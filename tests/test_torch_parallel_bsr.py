"""The distributed BSR operators of stormx_torch (BASELINE config #3's
partitioned path, ``stormx_torch.parallel.bsr``) against the JAX
package's, on ``tests/test_config3_bsr.py``'s operator made from the same
NumPy arrays, with CPU thread ranks over gloo
(``tests/test_torch_parallel.py`` says how).

Tolerances: partition tables and inverted diagonal blocks bit-equal; the
banded product bit-identical overlapped or not and within 1e-12 of the
serial ``BSR.matvec`` (``test_banded_matvec_matches_bsr``'s contract);
GMRES(30) histories within 1e-10 of the JAX package's at the same P with
equal iterations, within 1e-8 of the serial history (the JAX test's
partition-invariance contract), and solutions within 1e-6 of the dense
solve.
"""

import numpy as np
import pytest
import torch

import stormx.parallel as jpar
from stormx.solvers import SolverOptions as JOptions
from stormx_torch import parallel as tpar
from stormx_torch.parallel import bsr as tbsr
from stormx_torch.solvers import SolverOptions, gmres, make_operator

from _torch_parallel_cases import assert_history, assert_same_ranks, config3_bsr, np_, ranks

CPU = dict(device="cpu")
OPTS = dict(num_iterations=600, absolute_tolerance=1e-9, relative_tolerance=1e-9)
LAYOUTS = {"pool": (jpar.partition_bsr, tpar.partition_bsr),
           "band": (jpar.partition_bsr_banded, tpar.partition_bsr_banded)}


@pytest.fixture(scope="module")
def problem():
    jb, tb, b = config3_bsr()
    blocks, cols = np.asarray(jb.blocks), np.asarray(jb.cols)
    nb, K, nv, _ = blocks.shape
    a = np.zeros((nb * nv, nb * nv))
    for i in range(nb):
        for k in range(K):
            j = int(cols[i, k])
            a[i * nv:(i + 1) * nv, j * nv:(j + 1) * nv] += blocks[i, k]
    return jb, tb, b, np.linalg.solve(a, b)


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("layout", ["pool", "band"])
def test_partition_tables_match_jax(problem, layout, p):
    jb, tb, _, _ = problem
    jpart, tpart = LAYOUTS[layout]
    jp, tp = jpart(jb, p), tpart(tb, p, **CPU)
    scalars = ("num_parts", "nb_global", "nb_pad", "block_size") + (
        ("s_max",) if layout == "pool" else ("h_lo", "h_hi"))
    for name in scalars:
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("perm", "fill_slots"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    for jarr, tarr in zip(jp.op_arrays(), tp.op_arrays()):
        np.testing.assert_array_equal(np_(tarr), np.asarray(jarr))
    np.testing.assert_array_equal(np_(tp.extract_diag_inv()), np.asarray(jp.extract_diag_inv()))
    for r in range(p):
        assert torch.equal(tp.extract_diag_inv(r), tp.extract_diag_inv()[r])


def test_partition_bsr_bfs_and_natural_match_jax(problem):
    jb, tb, _, _ = problem
    for kw in (dict(method="bfs"), dict(reorder=False)):
        jp, tp = jpar.partition_bsr(jb, 4, **kw), tpar.partition_bsr(tb, 4, **kw, **CPU)
        np.testing.assert_array_equal(tp.fill_slots, jp.fill_slots)
        for jarr, tarr in zip(jp.op_arrays(), tp.op_arrays()):
            np.testing.assert_array_equal(np_(tarr), np.asarray(jarr))
    with pytest.raises(ValueError, match="unknown"):
        tpar.partition_bsr(tb, 2, method="metis", **CPU)
    with pytest.raises(ValueError, match="band"):
        tpar.partition_bsr_banded(tb, tb.blocks.shape[0], **CPU)


@pytest.mark.parametrize("layout", ["pool", "band"])
def test_vector_layout_round_trip_matches_jax(problem, layout):
    jb, tb, b, _ = problem
    jpart, tpart = LAYOUTS[layout]
    jp, tp = jpart(jb, 4), tpart(tb, 4, **CPU)
    xp = tpar.partition_bsr_vector(tp, b)
    np.testing.assert_array_equal(np_(xp), np.asarray(jpar.partition_bsr_vector(jp, b)))
    np.testing.assert_array_equal(np_(tpar.unpartition_bsr_vector(tp, xp)), b)


@pytest.mark.parametrize("layout", ["pool", "band"])
def test_matvec_matches_serial_bsr(problem, layout):
    """Both layouts' products within 1e-12 of ``BSR.matvec``; the banded
    one bit-identical with and without overlap."""
    _, tb, _, _ = problem
    x = np.random.default_rng(9).standard_normal(tb.shape[0])
    y_serial = np_(tb.matvec(torch.as_tensor(x)))
    tp = LAYOUTS[layout][1](tb, 8, **CPU)
    xp = tpar.partition_bsr_vector(tp, x)
    overlaps = (True, False) if layout == "band" else (None,)

    def run(mesh):
        kw = [{} if ov is None else dict(overlap=ov) for ov in overlaps]
        return [tp.local_matvec(mesh, **k)(xp[mesh.rank]) for k in kw]

    outs = ranks(8, run)
    ys = [np_(tbsr.unpartition_bsr_vector(tp, torch.stack([o[i] for o in outs])))
          for i in range(len(overlaps))]
    for y in ys:
        np.testing.assert_allclose(y, y_serial, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ys[0], ys[-1])


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("layout", ["pool", "band"])
def test_sharded_gmres_matches_jax_and_serial(problem, layout, p):
    """GMRES(30): every rank the same; the JAX history at the same P; the
    serial history within 1e-8; the dense solution within 1e-6."""
    jb, tb, b, truth = problem
    jpart, tpart = LAYOUTS[layout]
    tp = tpart(tb, p, **CPU)
    outs = ranks(p, lambda mesh: tpar.sharded_bsr_solve(
        tp, b, mesh=mesh, method="gmres", restart=30, options=SolverOptions(**OPTS)))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged
    np.testing.assert_allclose(np_(res.x), truth, atol=1e-6)
    jres = jpar.sharded_bsr_solve(jpart(jb, p), b, mesh=jpar.make_device_mesh(p),
                                  method="gmres", restart=30, options=JOptions(**OPTS))
    assert_history(res, jres)
    b_t = torch.as_tensor(b)
    serial = gmres(make_operator(tb.matvec), b_t, torch.zeros_like(b_t), restart=30,
                   options=SolverOptions(**OPTS))
    k = min(res.num_iterations, serial.num_iterations)
    np.testing.assert_allclose(np_(res.history)[: k + 1], np_(serial.history)[: k + 1],
                               rtol=1e-8)


@pytest.mark.parametrize("layout", ["pool", "band"])
def test_block_jacobi_and_fgmres_match_jax(problem, layout):
    """Block-Jacobi (GMRES and FGMRES) at P = 4 against the JAX package,
    no more iterations than unpreconditioned GMRES, and the banded layout
    takes the pool layout's iterations."""
    jb, tb, b, truth = problem
    jpart, tpart = LAYOUTS[layout]
    tp, jp = tpart(tb, 4, **CPU), jpart(jb, 4)
    jmesh = jpar.make_device_mesh(4)
    cases = (dict(method="gmres"), dict(method="gmres", block_jacobi=True),
             dict(method="fgmres", block_jacobi=True))
    outs = ranks(4, lambda mesh: [tpar.sharded_bsr_solve(
        tp, b, mesh=mesh, restart=30, options=SolverOptions(**OPTS), **kw) for kw in cases])
    plain, pre, _ = outs[0]
    for res, kw in zip(outs[0], cases):
        assert res.converged
        np.testing.assert_allclose(np_(res.x), truth, atol=1e-6)
        assert_history(res, jpar.sharded_bsr_solve(jp, b, mesh=jmesh, restart=30,
                                                   options=JOptions(**OPTS), **kw))
    assert pre.num_iterations <= plain.num_iterations
    pool = ranks(4, lambda mesh: tpar.sharded_bsr_solve(
        tpar.partition_bsr(tb, 4, **CPU), b, mesh=mesh, restart=30,
        options=SolverOptions(**OPTS), block_jacobi=True))[0]
    assert pool.num_iterations == pre.num_iterations
