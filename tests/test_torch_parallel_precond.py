"""Preconditioners inside the distributed solves of stormx_torch — Jacobi,
Chebyshev, Krylov, restricted additive Schwarz and ``DistributedAmg`` —
against the JAX package at the same partition count, with CPU thread ranks
over gloo (``tests/test_torch_parallel.py`` says how).

Tolerances: host builds bit-equal (RAS factors, the AMG slot layout and
its coarse hierarchy); float64 histories within 1e-10 relative with equal
iterations.  Two exceptions: ``DistributedAmg``'s restriction all-reduce
regroups sums inside the preconditioner, so, as in
``tests/test_distributed_amg.py``, its histories across partition counts and
packages agree within 1e-7; and RAS's triangular solves sum each level's
rows in torch's order, not XLA's.  Under CG + RAS-SGS that leaves the
histories within 1e-10 (measured: 2.4e-12 at the last of 48 iterations),
but BiCGStab + RAS-ILU(0) multiplies the first 1e-16 difference about ten
times every two iterations, to 4.6e-7 relative at its 28th (P = 2; the
first entries agree to 1e-16), so that history is held within 1e-6 with
equal iterations.  RAS histories depend on the partition count by design:
its iterations grow with P.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.parallel as jpar
from stormx import precond as jpre
from stormx.fvm.divgrad import assemble_laplacian as j_laplacian
from stormx.mesh import structured_tri_rect as j_rect
from stormx.solvers import SolverOptions as JOptions
from stormx_torch import parallel as tpar
from stormx_torch import precond as tpre
from stormx_torch.solvers import SolverOptions, fgmres, make_operator

from _torch_parallel_cases import (assert_history, assert_same_ranks, csr_pair, np_, poisson,
                                   ranks)

CPU = dict(device="cpu")


def _opts(cls, **kw):
    return cls(**{"absolute_tolerance": 1e-9, "relative_tolerance": 1e-9, **kw})


@pytest.fixture(scope="module")
def problem():
    a, b = poisson(16)
    jcsr, tcsr = csr_pair(a)
    return a, b, jcsr, tcsr


def test_jacobi_matches_jax(problem):
    a, b, jcsr, tcsr = problem
    tp = tpar.partition_csr(tcsr, 4, **CPU)
    outs = ranks(4, lambda mesh: [tpar.sharded_solve(tp, b, mesh=mesh, **kw)
                                  for kw in ({}, dict(precond_diag=np.diag(a)))])
    assert_same_ranks([o[1] for o in outs])
    plain, pre = outs[0]
    assert pre.converged and pre.num_iterations <= plain.num_iterations
    assert_history(pre, jpar.sharded_solve(jpar.partition_csr(jcsr, 4), b,
                                           precond_diag=np.diag(a)))


def test_chebyshev_partition_invariant_and_matches_jax(problem):
    """Explicit bounds (no build-phase estimate) make the preconditioner
    shard-safe: P = 1 and P = 8 agree, and with the JAX package."""
    _, b, jcsr, tcsr = problem
    kw = dict(degree=6, lambda_max=8.0, ratio=50.0)

    def run(p):
        tp = tpar.partition_csr(tcsr, p, **CPU)
        return ranks(p, lambda mesh: tpar.sharded_solve(
            tp, b, mesh=mesh, options=_opts(SolverOptions, num_iterations=400),
            precond=tpre.ChebyshevPreconditioner(**kw)))

    r1, r8 = run(1)[0], run(8)
    assert_same_ranks(r8)
    r8 = r8[0]
    assert r8.converged
    k = r1.num_iterations
    assert r8.num_iterations == k
    np.testing.assert_allclose(np_(r8.history)[: k + 1], np_(r1.history)[: k + 1], rtol=1e-10)
    jres = jpar.sharded_solve(jpar.partition_csr(jcsr, 8), b,
                              options=_opts(JOptions, num_iterations=400),
                              precond=jpre.ChebyshevPreconditioner(**kw))
    assert_history(r8, jres)


def test_krylov_fgmres_matches_jax_and_leaves_the_instance(problem):
    """FGMRES + an inner CG(6) at P = 4 against the JAX package; the user's
    instance is not re-wired and still serves a serial solve."""
    a, b, jcsr, tcsr = problem
    pre = tpre.KrylovPreconditioner(method="cg", num_iterations=6)
    tp = tpar.partition_csr(tcsr, 4, **CPU)
    outs = ranks(4, lambda mesh: tpar.sharded_solve(
        tp, b, mesh=mesh, method="fgmres", options=_opts(SolverOptions, num_iterations=200),
        precond=pre))
    assert_same_ranks(outs)
    res = outs[0]
    assert res.converged and pre._axis_name is None and pre._op is None
    assert np.abs(a @ np_(res.x) - b).max() < 1e-7
    jres = jpar.sharded_solve(jpar.partition_csr(jcsr, 4), b, method="fgmres",
                              options=_opts(JOptions, num_iterations=200),
                              precond=jpre.KrylovPreconditioner(method="cg", num_iterations=6))
    assert_history(res, jres)
    serial = fgmres(make_operator(tcsr.matvec), torch.as_tensor(b), torch.zeros(len(b),
                    dtype=torch.float64), precond=pre,
                    options=_opts(SolverOptions, num_iterations=200))
    assert serial.converged and np.abs(a @ np_(serial.x) - b).max() < 1e-7


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("kind", ["ilu0", "sgs"])
def test_ras_factors_match_jax(kind, p):
    a, _ = poisson(12)
    jcsr, tcsr = csr_pair(a)
    got = tpar.build_ras_factors(tpar.partition_csr(tcsr, p, **CPU), kind=kind)
    want = jpar.build_ras_factors(jpar.partition_csr(jcsr, p), kind=kind)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np_(got[key]), np.asarray(want[key]), err_msg=key)


def test_ras_matches_jax_and_grows_with_parts():
    """BiCGStab + RAS-ILU(0) and CG + RAS-SGS on the 24×24 operator at
    P = 2 and 4: each history equal to the JAX package's at the same P,
    fewer iterations than Jacobi, and no fewer at P = 4 than at P = 2."""
    a, b = poisson(24)
    jcsr, tcsr = csr_pair(a)
    iters = {}
    for p in (2, 4):
        tp, jp = tpar.partition_csr(tcsr, p, **CPU), jpar.partition_csr(jcsr, p)
        runs = (dict(method="bicgstab", ras="ilu0"), dict(method="cg", ras="sgs"),
                dict(method="bicgstab", precond_diag=np.diag(a)))
        outs = ranks(p, lambda mesh, tp=tp: [tpar.sharded_solve(
            tp, b, mesh=mesh, options=_opts(SolverOptions, num_iterations=400), **kw)
            for kw in runs])
        assert_same_ranks([o[0] for o in outs])
        ilu, sgs, jac = outs[0]
        for res, kw, rtol in zip((ilu, sgs), runs, (1e-6, 1e-10)):
            assert res.converged
            assert np.abs(a @ np_(res.x) - b).max() < 1e-7
            assert_history(res, jpar.sharded_solve(
                jp, b, options=_opts(JOptions, num_iterations=400), **kw), rtol=rtol)
        assert ilu.num_iterations < jac.num_iterations
        iters[p] = ilu.num_iterations
    assert iters[4] >= iters[2]


def test_ras_excludes_other_preconditioners(problem):
    _, b, _, tcsr = problem
    tp = tpar.partition_csr(tcsr, 1, **CPU)
    with pytest.raises(ValueError, match="excludes"):
        ranks(1, lambda mesh: tpar.sharded_solve(tp, b, mesh=mesh, ras="ilu0",
                                                 precond_diag=np.ones(len(b))))


@pytest.fixture(scope="module")
def laplacian():
    """``tests/test_distributed_amg.py``'s problem on a 640-cell mesh: the
    pure-Neumann Laplacian and a mean-free right-hand side."""
    from stormx.sparse import CSR as JCSR
    from stormx_torch.sparse.formats import CSR as TCSR

    mesh = j_rect(20, 16)
    csr = j_laplacian(mesh).to_csr()
    c = np.asarray(mesh.cell_centers)
    rhs = np.asarray(mesh.cell_volumes) * np.sin(2 * np.pi * c[:, 0]) * np.cos(np.pi * c[:, 1])
    arrays = [np.array(x) for x in (csr.data, csr.indices, csr.row_ptr)]
    return (JCSR(*(jnp.asarray(x) for x in arrays), shape=csr.shape),
            TCSR(*(torch.as_tensor(x) for x in arrays), shape=csr.shape),
            rhs - rhs.mean())


def test_distributed_amg_build_matches_jax(laplacian):
    jcsr, tcsr, _ = laplacian
    tp, jp = tpar.partition_csr(tcsr, 4, **CPU), jpar.partition_csr(jcsr, 4)
    tamg, jamg = tpar.DistributedAmg(tcsr, tp, **CPU), jpar.DistributedAmg(jcsr, jp)
    assert tamg.nc == jamg.nc
    np.testing.assert_array_equal(np_(tamg.agg_slots), np.asarray(jamg.agg_slots))
    np.testing.assert_array_equal(np_(tamg.idiag_slots), np.asarray(jamg.idiag_slots))
    assert len(tamg.coarse._levels) == len(jamg.coarse._levels)
    for tl, jl in zip(tamg.coarse._levels, jamg.coarse._levels):
        np.testing.assert_array_equal(np_(tl["agg"]), np.asarray(jl["agg"]))
    assert set(tamg.extras()) == set(jamg.extras())


def test_distributed_amg_partition_invariant_and_matches_jax(laplacian):
    jcsr, tcsr, rhs = laplacian
    opts = dict(num_iterations=3000, absolute_tolerance=0.0, relative_tolerance=1e-9)
    out = {}
    for p in (1, 8):
        tp = tpar.partition_csr(tcsr, p, **CPU)
        amg = tpar.DistributedAmg(tcsr, tp, **CPU)
        res = ranks(p, lambda mesh, tp=tp, amg=amg: tpar.sharded_solve(
            tp, rhs, mesh=mesh, amg=amg, options=SolverOptions(**opts)))
        assert_same_ranks(res)
        out[p] = res[0]
        assert out[p].converged
    k = out[1].num_iterations
    assert out[8].num_iterations == k
    np.testing.assert_allclose(np_(out[8].history)[: k + 1], np_(out[1].history)[: k + 1],
                               rtol=1e-7)
    jp = jpar.partition_csr(jcsr, 8)
    jres = jpar.sharded_solve(jp, rhs, amg=jpar.DistributedAmg(jcsr, jp),
                              options=JOptions(**opts))
    assert_history(out[8], jres, rtol=1e-7)
    tp = tpar.partition_csr(tcsr, 8, **CPU)
    diag = np.asarray(tcsr.todense().diagonal())
    jac = ranks(8, lambda mesh: tpar.sharded_solve(tp, rhs, mesh=mesh, precond_diag=diag,
                                                   options=SolverOptions(**opts)))[0]
    assert jac.converged and k < 0.5 * jac.num_iterations
    with pytest.raises(ValueError, match="excludes"):
        amg = tpar.DistributedAmg(tcsr, tp, **CPU)
        ranks(8, lambda mesh: tpar.sharded_solve(tp, rhs, mesh=mesh, amg=amg, precond_diag=diag))
