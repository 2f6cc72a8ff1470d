"""The CUDA kernels of stormx_torch against their plain PyTorch versions, on
the card.  Each test skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerances: K1 within 1e-5·max|y| (the kernel's FMA K-sum and torch's sum
differ in order); K3 bit-exact; a float32 Cahn–Hilliard step on the card
within 1e-4 of the float64 CPU step on a 2,560-cell mesh (cond(A) ~1e5 there,
so float32 rounding of A moves the solution by ~1e-5)."""

import numpy as np
import pytest
import torch

from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import build_mesh, structured_tri_rect
from stormx_torch.ops import banded_gather, sell_spmv
from stormx_torch.ops.banded_gather import BandedGatherPlan
from stormx_torch.sparse.formats import CSR
from stormx_torch.sparse.windowed import auto_operator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _delaunay_laplacian():
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(7).random((3000, 2))
    mesh = build_mesh(pts, Delaunay(pts).simplices)
    csr = assemble_laplacian(mesh).to_csr()
    return mesh, CSR(data=csr.data.float(), indices=csr.indices, row_ptr=csr.row_ptr,
                     shape=csr.shape)


def test_sell_kernel_matches_plain_version(cuda_device):
    mesh, csr = _delaunay_laplacian()
    op, _ = auto_operator(csr, coords=mesh.cell_centers, device=cuda_device)
    assert op.mode == "cuda"
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(csr.shape[0]),
                        dtype=torch.float32, device=cuda_device)
    before = sell_spmv.launches
    y_k = op.matvec(x)
    assert sell_spmv.launches == before + 1
    y_p = sell_spmv.sell_spmv_plain(op, x)
    assert float((y_k - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    with pytest.raises(ValueError):
        sell_spmv.sell_spmv_cuda(op, x.double())


def _gather_cases(rng):
    yield np.sort(rng.integers(0, 5000, 11000)), 5000
    idx = np.sort(rng.integers(0, 5000, 11000))
    idx[::977] = rng.integers(0, 5000, len(idx[::977]))
    yield idx, 5000
    yield rng.integers(0, 5000, 3000), 5000
    yield np.sort(rng.integers(0, 5000, 127)), 5000
    yield np.array([4321]), 5000


def test_gather_kernel_bit_exact(cuda_device):
    rng = np.random.default_rng(0)
    for idx, n in _gather_cases(rng):
        plan = BandedGatherPlan(idx, n, device=cuda_device)
        for x in (rng.standard_normal(n).astype(np.float32), rng.standard_normal((n, 3)),
                  rng.integers(0, 1 << 15, n).astype(np.int16)):
            xt = torch.as_tensor(x, device=cuda_device)
            before = banded_gather.launches
            y = plan(xt)
            assert banded_gather.launches == before + 1
            assert torch.equal(y, banded_gather.banded_gather_plain(plan, xt))
            assert np.array_equal(y.cpu().numpy(), x[idx])


def test_assembled_step_on_card_matches_cpu(cuda_device):
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.solvers import SolverOptions

    mesh = structured_tri_rect(40, 32).optimize_ordering()
    opts = SolverOptions(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-6)
    gpu = make_assembled_step(mesh, options=opts, dtype=torch.float32, device=cuda_device)
    cpu = make_assembled_step(mesh, options=opts, dtype=torch.float64, device="cpu")
    assert gpu.operator.mode == "cuda" and gpu.dmesh.bg_face_inner is not None
    c0 = 0.5 + 0.1 * np.random.default_rng(0).standard_normal(mesh.num_cells)
    k1, k3 = sell_spmv.launches, banded_gather.launches
    c_g, r_g = gpu(torch.as_tensor(c0, dtype=torch.float32, device=cuda_device))
    c_c, r_c = cpu(torch.as_tensor(c0))
    assert sell_spmv.launches > k1 and banded_gather.launches > k3
    assert r_g.converged and r_c.converged
    assert float((c_g.double().cpu() - c_c).abs().max()) <= 1e-4
