"""The distributed layer of stormx_torch on the card: kernel K1 on the slab
operators of the sliced path, thread ranks sharing the card over gloo, and
NCCL at world size 1.  Each test skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it runs where JAX is
absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_card.py -q

Tolerances: K1 within 1e-5·max|y| of its plain version (the kernel's FMA
K-sum and torch's sum differ in order); a float32 sharded CG at P = 2 takes
the iterations of P = 1 within 2% (the dots are summed in another order).
"""

import numpy as np
import pytest
import torch

from stormx_torch import parallel as tpar
from stormx_torch.parallel.comm import run_thread_ranks
from stormx_torch.core.exceptions import StormError
from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import structured_tri_rect
from stormx_torch.ops import sell_spmv
from stormx_torch.solvers import SolverOptions
from stormx_torch.sparse.formats import CSR
from stormx_torch.sparse.windowed import SlicedELL

pytestmark = pytest.mark.cuda

OPTS = SolverOptions(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operator(nx=60, ny=50):
    """A float32 mesh Laplacian shifted off its nullspace (host CSR)."""
    csr = assemble_laplacian(structured_tri_rect(nx, ny)).to_csr()
    data = csr.data.double().numpy().copy()
    idx, rp = csr.indices.numpy(), csr.row_ptr.numpy()
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(rp))
    data[idx == rows] += 0.1
    return CSR(data=data.astype(np.float32), indices=idx, row_ptr=rp, shape=csr.shape)


def test_k1_on_slab_operators(cuda_device):
    """The extended slab [left halo | x_loc | right halo] with pad_lo = 0,
    and a contiguous block range of it, through K1 against the plain
    version."""
    ps = tpar.partition_sliced(_operator(), 2, mode="pallas", block_rows=128,
                               device=cuda_device)
    R, C = ps.block_rows, ps.window
    gen = torch.Generator(device="cpu").manual_seed(0)
    for rank in range(2):
        slab = SlicedELL(data=ps.ell_data[rank].contiguous(),
                         local_cols=ps.ell_cols[rank].contiguous(),
                         shape=(ps.n_loc, ps.n_loc + C - R), window=C, pad_lo=0, mode="cuda",
                         dense_blocks=None)
        x = torch.randn(slab.shape[1], generator=gen).to(cuda_device)
        lo, hi = 1, ps.n_loc // R - 1
        block = SlicedELL(data=slab.data[lo:hi], local_cols=slab.local_cols[lo:hi],
                          shape=((hi - lo) * R, slab.shape[1] - lo * R), window=C, pad_lo=0,
                          mode="cuda", dense_blocks=None)
        for op, v in ((slab, x), (block, x[lo * R:])):
            before = sell_spmv.launches
            y = sell_spmv.sell_spmv(op, v)
            assert sell_spmv.launches == before + 1
            y_p = sell_spmv.sell_spmv_plain(op, v)
            torch.cuda.synchronize()
            assert float((y - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())


def test_sharded_sliced_cg_on_card_p2_matches_p1(cuda_device):
    """Two thread ranks share the card over gloo: K1 on every slab product
    (three launches each with overlap), the same iterations as one rank."""
    csr = _operator()
    b = np.random.default_rng(1).standard_normal(csr.shape[0]).astype(np.float32)
    out = {}
    for p in (1, 2):
        ps = tpar.partition_sliced(csr, p, mode="pallas", block_rows=128, device=cuda_device)
        before = sell_spmv.launches
        res = run_thread_ranks(p, lambda mesh, ps=ps: tpar.sharded_sliced_solve(
            ps, b, mesh=mesh, options=OPTS), device=cuda_device, timeout=60)
        launches = sell_spmv.launches - before
        assert all(r.converged for r in res)
        assert len({r.num_iterations for r in res}) == 1
        assert launches == p * 3 * (res[0].num_iterations + 1)
        out[p] = res[0]
        assert out[p].x.is_cuda and out[p].x.dtype == torch.float32
    assert abs(out[2].num_iterations - out[1].num_iterations) <= 0.02 * out[1].num_iterations
    gap = float((out[2].x - out[1].x).abs().max() / out[1].x.abs().max())
    assert gap < 1e-4


def test_nccl_world_size_one_sharded_solve(cuda_device, monkeypatch):
    """One rank under NCCL drives a sharded CG whose reductions are NCCL
    all-reduces; asking NCCL for more ranks on this host than cards
    raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    csr = _operator(30, 20)
    b = np.random.default_rng(2).standard_normal(csr.shape[0]).astype(np.float32)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = tpar.make_device_mesh(1)
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        pop = tpar.partition_csr(csr, 1, device=cuda_device)
        res = tpar.sharded_solve(pop, b, mesh=mesh, options=OPTS)
        assert res.converged and mesh.calls["all_reduce"] > res.num_iterations
        a = torch.sparse_csr_tensor(torch.as_tensor(csr.row_ptr, dtype=torch.int64),
                                    torch.as_tensor(csr.indices, dtype=torch.int64),
                                    torch.as_tensor(csr.data, dtype=torch.float64),
                                    size=csr.shape)
        r = torch.as_tensor(b, dtype=torch.float64) - a @ res.x.double().cpu()
        assert float(r.norm() / np.linalg.norm(b)) < 1e-4
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
        with pytest.raises(StormError, match="one rank per card"):
            tpar.make_device_mesh(1)
    finally:
        dist.destroy_process_group()
