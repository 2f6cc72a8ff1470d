"""Communication-volume accounting of stormx_torch
(``stormx_torch.parallel.commvol``) against the JAX package's reports, and
against the bytes the ranks' collectives really moved in one product
(``RankMesh.moved``), with CPU thread ranks over gloo.

Every report is equal to the JAX package's, field for field, on the same
partitions (float32 operators where the JAX ``sliced_band_volume`` counts
4 bytes an item whatever the dtype); ``project_scaling`` is equal given
the JAX package's interconnect figures, which the port does not carry and
takes only as arguments; each layout's ``moved_bytes`` equals the bytes
its ranks received in one product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.parallel as jpar
from stormx.fvm import assemble_convection_diffusion as j_convdiff
from stormx.mesh.structured import structured_tri_rect as j_rect
from stormx.parallel import commvol as jcv
from stormx.sparse import CSR as JCSR
from stormx_torch import parallel as tpar
from stormx_torch.parallel import commvol as tcv
from stormx_torch.sparse.formats import CSR as TCSR

from _torch_parallel_cases import config3_bsr, poisson_dia, ranks

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def convdiff():
    """``TestCommunicationVolume._mesh_operator``: convection–diffusion on
    a 40 × 40 triangle rectangle, in float64 and float32, in both
    packages."""
    def vel(r):
        c = r - 0.5
        return np.stack([-c[:, 1] - 0.4, c[:, 0] + 0.8], axis=1)

    csr = j_convdiff(j_rect(40, 40), vel, 0.05).to_csr()
    rp, idx = np.array(csr.row_ptr), np.array(csr.indices)
    out = {}
    for dt in (np.float64, np.float32):
        data = np.asarray(csr.data).astype(dt)
        out[dt] = (JCSR(data=jnp.asarray(data), indices=jnp.asarray(idx),
                        row_ptr=jnp.asarray(rp), shape=csr.shape),
                   TCSR(data=torch.as_tensor(data), indices=torch.as_tensor(idx),
                        row_ptr=torch.as_tensor(rp), shape=csr.shape))
    return out


@pytest.fixture(scope="module")
def bsr():
    jb, tb, _ = config3_bsr()
    return jb, tb


def _partitions(convdiff, bsr, p):
    """(name, JAX report, port report, port partition) per layout at P."""
    (jc, tc), (jc32, tc32) = convdiff[np.float64], convdiff[np.float32]
    jd, td = poisson_dia(64)
    jb, tb = bsr
    tp = {"csr_pool": tpar.partition_csr(tc, p, **CPU),
          "dia_halo": tpar.partition_dia(td, p, **CPU),
          "sliced_band": tpar.partition_sliced(tc32, p, mode="dense", **CPU),
          "bsr_pool": tpar.partition_bsr(tb, p, **CPU),
          "bsr_band": tpar.partition_bsr_banded(tb, p, **CPU)}
    jp = {"csr_pool": jpar.partition_csr(jc, p),
          "dia_halo": jpar.partition_dia(jd, p),
          "sliced_band": jpar.partition_sliced(jc32, p, mode="dense"),
          "bsr_pool": jpar.partition_bsr(jb, p),
          "bsr_band": jpar.partition_bsr_banded(jb, p)}
    return [(name, getattr(jcv, f"{name}_volume")(jp[name]),
             getattr(tcv, f"{name}_volume")(tp[name]), tp[name]) for name in tp]


@pytest.mark.parametrize("p", [2, 4, 8])
def test_reports_match_jax(convdiff, bsr, p):
    for name, want, got, _ in _partitions(convdiff, bsr, p):
        assert got == want, name


def test_halo_paths_move_constant_per_link(convdiff):
    """``test_halo_paths_move_constant_per_link`` and
    ``test_pool_shared_set_is_boundary_not_volume`` on the port's
    partitions."""
    _, tc32 = convdiff[np.float32]
    _, tc = convdiff[np.float64]
    per_link = [tcv.sliced_band_volume(tpar.partition_sliced(tc32, p, mode="dense", **CPU))
                ["moved_elems"] / (p - 1) for p in (2, 4, 8)]
    assert max(per_link) == min(per_link)
    _, td = poisson_dia(64)
    per_link = [tcv.dia_halo_volume(tpar.partition_dia(td, p, **CPU))["moved_elems"] / (p - 1)
                for p in (2, 4, 8)]
    assert per_link == [2 * 64] * 3  # h = max|offset| each way
    for p in (2, 4, 8):
        pop = tpar.partition_csr(tc, p, **CPU)
        assert pop.s_max < 0.35 * pop.n_pad
        rep = tcv.csr_pool_volume(pop)
        assert rep["moved_elems"] == p * (p - 1) * pop.s_max
        assert rep["moved_bytes"] == 8 * rep["moved_elems"] and 0 < rep["ratio"] < 1


@pytest.mark.parametrize("p", [2, 4])
def test_reports_equal_counted_bytes(convdiff, bsr, p):
    """One product on every layout with each rank's ``moved`` counter
    cleared just before it: the bytes received, summed over the ranks,
    are the report's ``moved_bytes``."""
    for name, _, rep, part in _partitions(convdiff, bsr, p):
        dtype = (part.op_arrays()[0] if hasattr(part, "op_arrays") else part.data).dtype
        if name.startswith("bsr"):
            x = torch.randn(p, part.nb_pad, part.block_size, dtype=dtype)
        else:
            x = torch.randn(p, getattr(part, "n_pad", None) or part.n_loc, dtype=dtype)

        def one_product(mesh, part=part, x=x):
            local = part.local_matvec(mesh)
            mesh.moved.clear()
            local(x[mesh.rank])
            return sum(mesh.moved.values())

        assert sum(ranks(p, one_product)) == rep["moved_bytes"], name


def test_project_scaling_matches_jax():
    """``test_scaling_projection_model``'s cases, each equal to the JAX
    report given the JAX defaults as arguments; the port takes no default
    link figures."""
    link = dict(link_bw=jcv.V5E_ICI_LINK_BW, latency_s=jcv.V5E_ICI_LATENCY_S)
    cases = [(71.5e-6, 2048 * 4, p) for p in (2, 4, 8, 16)]
    cases += [(30.0e-6, 260 * 4, p) for p in (2, 4, 8, 16)]
    cases += [(3.1e-6, (p - 1) * 360 * 5 * 4, p) for p in (4, 8, 16)]
    for args in cases:
        for overlap in (True, False):
            assert tcv.project_scaling(*args, overlap=overlap, **link) == jcv.project_scaling(
                *args, overlap=overlap)
    with pytest.raises(TypeError):
        tcv.project_scaling(71.5e-6, 2048 * 4, 8)
    assert not hasattr(tcv, "V5E_ICI_LINK_BW") and not hasattr(tcv, "V5E_ICI_LATENCY_S")
