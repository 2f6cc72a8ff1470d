"""The distributed FV march of stormx_torch (``stormx_torch.parallel.fvm``)
against the JAX package's and against the port's serial ``FvSolver.march``,
on ``tests/test_parallel.py``'s ``TestShardedFvMarch`` inputs made from the
same NumPy arrays, with CPU thread ranks over gloo.

Tolerances: the partition tables bit-equal to the JAX package's; the march
BIT-EXACT against the port's serial march at every P, with K3's plans
(their plain version here) and without, since every rank keeps the serial
per-face and per-cell order (the JAX contract is atol 1e-12 against its
serial march); and within 1e-10 of the JAX march at order 1 (atol 1e-12, the JAX
contract) and, at order 2, within 1e-10 relative to the largest state
entry, the tolerance of the serial marches' own parity test
(``tests/test_torch_euler.py``: the order-2 gradients of the two corner
cells, whose LSQ systems are singular, carry rounding no two summation
orders agree on).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.fvm as J
import stormx.parallel as jpar
import stormx_torch.fvm as T
from stormx.apps.euler import initial_state
from stormx.fvm.flux import hllc_flux as j_hllc_flux
from stormx_torch import parallel as tpar
from stormx_torch.core.exceptions import StormError

from _torch_parallel_cases import index_gathers, np_, ranks, tri_mesh_pair

F64 = torch.float64
MARCH_REL = 1e-10


@pytest.fixture(scope="module")
def ragged():
    """The 60-cell mesh, ragged over 8 parts, with the perturbed state."""
    jm, tm = tri_mesh_pair(6, 5)
    u0 = np.array(initial_state(jm.num_cells))
    u0[:, 0] += 0.1 * np.random.default_rng(2).random(jm.num_cells)
    return (jm.device_arrays(), tm.device_arrays(F64, device="cpu", banded_gather=False), u0)


def _march(tp, u0, p, **kw):
    outs = ranks(p, lambda mesh: tpar.sharded_fv_march(tp, u0, mesh=mesh, **kw))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("depth", [1, 2])
def test_partition_tables_match_jax(ragged, p, depth):
    jd, td, _ = ragged
    jp, tp = jpar.partition_fv(jd, p, halo_depth=depth), tpar.partition_fv(td, p,
                                                                          halo_depth=depth)
    for name in ("n_loc", "n_global", "h_max", "c_max", "s_max", "f_max", "unique_labels"):
        assert getattr(tp, name) == getattr(jp, name), name
    for jt, tt in zip(jp.tables(), tp.tables()):
        np.testing.assert_array_equal(np_(tt), np.asarray(jt))


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("order", [1, 2])
def test_march_matches_serial_and_jax(ragged, order, p, monkeypatch):
    """20 steps at dt = 1e-3 with slip walls, through K3's plans and
    through tensor indexing: the port's serial march bit for bit; the JAX
    sharded march at atol 1e-12 at order 1, within ``MARCH_REL`` at
    order 2."""
    jd, td, u0 = ragged
    bcs = {1: T.slip_bc}
    serial = T.FvSolver(td, order=order, bcs=bcs).march(torch.as_tensor(u0), 1e-3, 20)
    kw = dict(dt=1e-3, num_steps=20, bcs=bcs, order=order)
    got = _march(tpar.partition_fv(td, p), u0, p, **kw)
    assert torch.equal(got, serial)
    index_gathers(monkeypatch)
    assert torch.equal(_march(tpar.partition_fv(td, p), u0, p, **kw), serial)
    want = np.asarray(jpar.sharded_fv_march(jpar.partition_fv(jd, p), jnp.asarray(u0), 1e-3, 20,
                                            bcs={1: J.slip_bc}, order=order,
                                            mesh=jpar.make_device_mesh(p)))
    if order == 1:
        np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-12)
    else:
        assert np.abs(np_(got) - want).max() <= MARCH_REL * np.abs(want).max()


def test_hllc_distributed():
    """``test_hllc_distributed``: HLLC, order 1, far field, P = 4 on the
    32-cell mesh, against both serial marches."""
    jm, tm = tri_mesh_pair(4, 4)
    jd, td = jm.device_arrays(), tm.device_arrays(F64, device="cpu", banded_gather=False)
    u0 = np.array(initial_state(jm.num_cells))
    serial = T.FvSolver(td, order=1, bcs={1: T.far_field_bc}, flux_scheme=T.hllc_flux).march(
        torch.as_tensor(u0), 1e-3, 10)
    got = _march(tpar.partition_fv(td, 4), u0, 4, dt=1e-3, num_steps=10,
                 bcs={1: T.far_field_bc}, flux_scheme=T.hllc_flux)
    assert torch.equal(got, serial)
    want = np.asarray(J.FvSolver(jd, order=1, bcs={1: J.far_field_bc},
                                 flux_scheme=j_hllc_flux).march(jnp.asarray(u0), 1e-3, 10))
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-12)


def test_march_checks_its_arguments(ragged):
    _, td, u0 = ragged
    with pytest.raises(ValueError, match="halo_depth=2"):
        ranks(2, lambda mesh: tpar.sharded_fv_march(tpar.partition_fv(td, 2, halo_depth=1), u0,
                                                    1e-3, 1, bcs={1: T.slip_bc}, mesh=mesh,
                                                    order=2))
    with pytest.raises(StormError, match="no boundary condition"):
        ranks(2, lambda mesh: tpar.sharded_fv_march(tpar.partition_fv(td, 2), u0, 1e-3, 1,
                                                    bcs={}, mesh=mesh))


def test_local_mesh_plans_match_tables(ragged):
    """Each rank's K3 plans gather what its tables index, bit for bit; the
    local mesh is built once per (rank, device, dtype) and does not
    travel with a pickled partition."""
    import pickle

    from stormx_torch.ops.banded_gather import BandedGatherPlan

    _, td, _ = ragged
    tp = tpar.partition_fv(td, 4)
    lm = tp.local_mesh(1, "cpu", F64)
    assert tp.local_mesh(1, "cpu", F64) is lm
    x = torch.randn(tp.c_max, 3, dtype=F64)
    for attr, table in (("bg_face_inner", "l_inner"), ("bg_face_outer", "l_outer"),
                        ("bg_cell_adj", "adj")):
        assert isinstance(getattr(lm, attr), BandedGatherPlan)
        idx = torch.as_tensor(getattr(tp, table)[1].reshape(-1).astype(np.int64))
        assert torch.equal(getattr(lm, attr)(x), x[idx])
    f = torch.randn(tp.f_max, dtype=F64)
    assert torch.equal(lm.bg_cell_face(f), f[torch.as_tensor(tp.cf_ell[1].reshape(-1),
                                                              dtype=torch.long)])
    assert pickle.loads(pickle.dumps(tp))._local == {}
