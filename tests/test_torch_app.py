"""The slice as a whole against the JAX package, in float64 on the CPU:
div_grad with and without the banded-gather plans, the Cahn–Hilliard steps
(matrix-free and assembled) over 1 and then 3 steps, and Milestone A (CG +
Jacobi on the two-point-flux Laplacian).

Tolerances: div_grad is bit-identical between the port's two gather paths
and within 1e-13 of JAX (sum order); the CH steps within 1e-11 (as
``tests/test_assembled_app.py:61-65``); Milestone-A histories within 1e-10
relative (or 1e-13 of the initial residual at the tail) with equal
iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.apps.cahn_hilliard import make_assembled_step as j_make_assembled_step
from stormx.apps.cahn_hilliard import make_step as j_make_step
from stormx.fvm.divgrad import assemble_laplacian as j_assemble_laplacian
from stormx.fvm.divgrad import div_grad as j_div_grad
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.precond import JacobiPreconditioner as JJacobi
from stormx.solvers import SolverOptions as JOptions
from stormx.solvers import cg as j_cg
from stormx.solvers import make_operator as j_make_operator
from stormx_torch.apps.cahn_hilliard import make_assembled_step, make_step, run
from stormx_torch.fvm.divgrad import assemble_laplacian, div_grad
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.precond import JacobiPreconditioner
from stormx_torch.solvers import SolverOptions, cg, make_operator

F64 = torch.float64


@pytest.fixture(scope="module")
def meshes():
    return structured_tri_rect(24, 20).optimize_ordering(), j_rect(24, 20).optimize_for_tpu()


class TestDivGrad:
    @pytest.mark.parametrize("nv", [None, 3])
    def test_matches_jax_with_and_without_plans(self, meshes, nv):
        tm, jm = meshes
        rng = np.random.default_rng(1)
        shape = (tm.num_cells,) if nv is None else (tm.num_cells, nv)
        c, u = rng.standard_normal(shape), rng.standard_normal(shape)
        td = tm.device_arrays(dtype=F64, device="cpu")
        tdb = tm.device_arrays(dtype=F64, device="cpu", banded_gather=True)
        assert td.bg_face_inner is None and tdb.bg_face_inner is not None
        y0 = div_grad(td, torch.as_tensor(u), 0.1, torch.as_tensor(c)).numpy()
        y1 = div_grad(tdb, torch.as_tensor(u), 0.1, torch.as_tensor(c)).numpy()
        assert np.array_equal(y0, y1)
        for jd in (jm.device_arrays(), jm.device_arrays(banded_gather=True)):
            yj = np.asarray(j_div_grad(jd, jnp.asarray(u), 0.1, jnp.asarray(c)))
            np.testing.assert_allclose(y0, yj, rtol=0, atol=1e-13 * np.abs(yj).max())


CH_OPTS = dict(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-12)


def _c0(n):
    return 0.5 + 0.1 * np.random.default_rng(0).standard_normal(n)


class TestCahnHilliard:
    @pytest.mark.parametrize("plans", [False, True])
    def test_matrix_free_step(self, meshes, plans):
        tm, jm = meshes
        td = tm.device_arrays(dtype=F64, device="cpu", banded_gather=plans)
        ts = make_step(td, options=SolverOptions(**CH_OPTS), device="cpu")
        js = j_make_step(jm.device_arrays(banded_gather=plans), options=JOptions(**CH_OPTS))
        c_t, c_j = torch.as_tensor(_c0(tm.num_cells)), jnp.asarray(_c0(tm.num_cells))
        for k in range(3):
            c_t, rt = ts(c_t)
            c_j, rj = js(c_j)
            assert rt.converged and bool(rj.converged)
            if k == 0:
                assert rt.num_iterations == int(rj.num_iterations)
            np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-11)

    def test_assembled_step(self, meshes):
        tm, jm = meshes
        ts = make_assembled_step(tm, options=SolverOptions(**CH_OPTS), dtype=F64, device="cpu")
        js = j_make_assembled_step(jm, options=JOptions(**CH_OPTS))
        assert ts.operator.mode == "dense"  # the kernel mode needs CUDA
        c_t, c_j = torch.as_tensor(_c0(tm.num_cells)), jnp.asarray(_c0(tm.num_cells))
        for k in range(3):
            c_t, rt = ts(c_t)
            c_j, rj = js(c_j)
            assert rt.converged and bool(rj.converged)
            if k == 0:
                assert rt.num_iterations == int(rj.num_iterations)
                h_t = rt.history.numpy()[: rt.num_iterations + 1]
                h_j = np.asarray(rj.history)[: rt.num_iterations + 1]
                np.testing.assert_allclose(h_t, h_j, rtol=1e-9)
            np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-11)

    def test_assembled_through_the_kernel_mode_plain_version(self, meshes):
        # mode="cuda" on CPU tensors runs K1's plain version: same steps.
        import dataclasses

        tm, _ = meshes
        ts = make_assembled_step(tm, options=SolverOptions(**CH_OPTS), dtype=F64, device="cpu")
        c0 = torch.as_tensor(_c0(tm.num_cells))
        c_ref, _ = ts(c0)
        op = ts.operator
        op_k = dataclasses.replace(op, mode="cuda", dense_blocks=None)
        y0 = op.matvec(c0)
        np.testing.assert_allclose(op_k.matvec(c0).numpy(), y0.numpy(),
                                   atol=1e-12 * float(y0.abs().max()))
        assert torch.isfinite(c_ref).all()

    @pytest.mark.parametrize("assembled", [False, True])
    def test_options_per_call(self, meshes, assembled):
        """``step(c, options=o)`` is the step made with ``o``;
        ``options=None`` keeps the options the step was made with."""
        tm, _ = meshes

        def make(opts):
            if assembled:
                return make_assembled_step(tm, options=opts, dtype=F64, device="cpu")
            return make_step(tm.device_arrays(dtype=F64, device="cpu"), options=opts,
                             device="cpu")

        made = SolverOptions(**CH_OPTS)
        short = SolverOptions(num_iterations=5, absolute_tolerance=0.0,
                              relative_tolerance=1e-12, record_history=False)
        step = make(made)
        c0 = torch.as_tensor(_c0(tm.num_cells))
        c_call, r_call = step(c0, options=short)
        c_made, r_made = make(short)(c0)
        assert r_call.num_iterations == r_made.num_iterations == 5
        assert not r_call.converged and r_call.history is None
        assert torch.equal(c_call, c_made)
        c_none, r_none = step(c0, options=None)
        c_def, r_def = step(c0)
        assert r_none.converged and r_none.num_iterations > 5
        assert r_none.num_iterations == r_def.num_iterations
        assert r_none.history is not None
        assert torch.equal(c_none, c_def)

    def test_run_matches_stepping_and_refuses_side_channels(self, meshes, tmp_path):
        """``run`` equals stepping; the side channels (snapshots, checkpoints)
        now run (``tests/test_torch_io.py`` holds them to the JAX package),
        and ``assembled=True`` without the host mesh is still refused."""
        from stormx_torch.io import Checkpointer, latest_step

        tm, _ = meshes
        td = tm.device_arrays(dtype=F64, device="cpu")
        opts = SolverOptions(**CH_OPTS)
        c0 = torch.as_tensor(_c0(tm.num_cells))
        step = make_step(td, options=opts, device="cpu")
        c = c0
        for _ in range(2):
            c, _ = step(c)
        assert torch.equal(run(td, c0, 2, options=opts, device="cpu"), c)
        c_as = run(td, c0, 2, mesh=tm, assembled=True, options=opts, dtype=F64, device="cpu")
        np.testing.assert_allclose(c_as.numpy(), c.numpy(), atol=1e-11)
        c_side = run(td, c0, 2, output_every=1, mesh=tm, output_dir=str(tmp_path),
                     checkpointer=Checkpointer(str(tmp_path / "ck"), every=1), options=opts,
                     device="cpu")
        assert torch.equal(c_side, c)
        assert sorted(p.name for p in tmp_path.glob("*.vtk")) == [
            "out_cahn_hilliard_1.vtk", "out_cahn_hilliard_2.vtk"]
        assert latest_step(str(tmp_path / "ck")) == 2
        with pytest.raises(ValueError):
            run(td, c0, 1, assembled=True, device="cpu")


MA_OPTS = dict(num_iterations=4000, absolute_tolerance=0.0, relative_tolerance=1e-8)


def test_milestone_a_poisson():
    tm = structured_tri_rect(32, 24)
    jm = j_rect(32, 24)
    Lt, Lj = assemble_laplacian(tm), j_assemble_laplacian(jm)
    n = tm.num_cells
    c = tm.cell_centers
    rhs = tm.cell_volumes * np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
    rhs = rhs - rhs.mean()
    diag = Lt.diagonal()
    t = cg(make_operator(Lt.matvec), torch.as_tensor(rhs), torch.zeros(n, dtype=F64),
           precond=JacobiPreconditioner(diag=diag), options=SolverOptions(**MA_OPTS))
    j = j_cg(j_make_operator(Lj.matvec), jnp.asarray(rhs), jnp.zeros(n),
             precond=JJacobi(diag=jnp.asarray(diag.numpy())), options=JOptions(**MA_OPTS))
    assert t.converged and bool(j.converged)
    k = t.num_iterations
    assert 0 < k == int(j.num_iterations)
    # The tail of the history lies 1e-8 below ‖r0‖, where one rounding of a
    # dot product (‖r0‖·eps ≈ 1e-16·‖r0‖) is 1e-8 of the current value: the
    # histories agree to 1e-10 relative or to 1e-13·‖r0‖, whichever is looser.
    h_t, h_j = t.history.numpy()[: k + 1], np.asarray(j.history)[: k + 1]
    np.testing.assert_allclose(h_t, h_j, rtol=1e-10, atol=1e-13 * h_j[0])
    r = Lt.matvec(t.x).numpy() - rhs
    assert np.linalg.norm(r) <= 1.1e-8 * np.linalg.norm(rhs)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-10)


def test_milestone_a_through_auto_operator():
    # The same solve in permuted space through SlicedELL (auto_operator),
    # as chip_smoke.py runs it on the card.
    from stormx_torch.sparse.windowed import SlicedELL, auto_operator

    tm = structured_tri_rect(32, 24)
    Lt = assemble_laplacian(tm)
    op, perm = auto_operator(Lt.to_csr(), coords=tm.cell_centers, max_diags=4, device="cpu")
    assert isinstance(op, SlicedELL)
    c = tm.cell_centers
    rhs = tm.cell_volumes * np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
    rhs = rhs - rhs.mean()
    diag = Lt.diagonal().numpy()
    res = cg(make_operator(op.matvec), torch.as_tensor(rhs[perm]), torch.zeros(len(rhs), dtype=F64),
             precond=JacobiPreconditioner(diag=torch.as_tensor(diag[perm])),
             options=SolverOptions(**MA_OPTS))
    assert res.converged
    x = np.empty(len(rhs))
    x[perm] = res.x.numpy()
    r = Lt.matvec(torch.as_tensor(x)).numpy() - rhs
    assert np.linalg.norm(r) <= 1.1e-8 * np.linalg.norm(rhs)
