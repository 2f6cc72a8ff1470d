"""The distributed layer of stormx_torch on the card: kernel K1 on the slab
operators of the sliced path, thread ranks sharing the card over gloo, and
NCCL at world size 1; K3 on a rank's local FV tables, K2a under the
distributed block AMG and the sharded BSR solve.  Each test skips without a
CUDA card.

This file imports neither JAX nor the JAX package, so it runs where JAX is
absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_card.py -q

Tolerances: K1 within 1e-5·max|y| of its plain version (the kernel's FMA
K-sum and torch's sum differ in order); a float32 sharded CG at P = 2 takes
the iterations of P = 1 within 2% (the dots are summed in another order);
K3 on the FV tables bit-equal to tensor indexing; the float64 block-AMG
apply within 1e-12·max of the serial ``BlockDiaAmg``'s (both through K2a;
the restriction adds each aggregate's entries in another order); the
float64 sharded BSR GMRES at P = 1 within 1e-10 of the serial history.
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


@pytest.fixture
def nccl_mesh(cuda_device):
    """A world of one rank under NCCL, destroyed after the test."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield tpar.make_device_mesh(1)
    finally:
        dist.destroy_process_group()


def test_k3_on_rank_fv_tables(cuda_device):
    """Every K3 plan of a rank's local mesh (P = 4, rank 1) launches the
    kernel once a call and gathers what its table indexes, bit for bit,
    in float32 and float64 at the Euler width."""
    from stormx_torch.ops import banded_gather

    dm = structured_tri_rect(40, 30).device_arrays(torch.float64, device="cpu",
                                                   banded_gather=False)
    pfv = tpar.partition_fv(dm, 4)
    sources = {"bg_face_inner": ("l_inner", pfv.c_max), "bg_face_outer": ("l_outer", pfv.c_max),
               "bg_cell_face": ("cf_ell", pfv.f_max), "bg_cell_adj": ("adj", pfv.c_max),
               "bg_send": ("send_slots", pfv.n_loc),
               "bg_halo": ("halo_src", pfv.num_parts * pfv.s_max)}
    gen = torch.Generator(device="cpu").manual_seed(3)
    for dtype in (torch.float32, torch.float64):
        lm = pfv.local_mesh(1, cuda_device, dtype)
        for attr, (table, n_src) in sources.items():
            idx = torch.as_tensor(getattr(pfv, table)[1].reshape(-1).astype(np.int64),
                                  device=cuda_device)
            x = torch.randn(n_src, 4, generator=gen, dtype=dtype).to(cuda_device)
            before = banded_gather.launches
            y = getattr(lm, attr)(x)
            assert banded_gather.launches == before + 1, attr
            assert torch.equal(y, x[idx]), attr


def test_block_amg_apply_p1_nccl_matches_serial(nccl_mesh):
    """``DistributedBlockDiaAmg`` at P = 1 under NCCL against the serial
    ``BlockDiaAmg`` on the card, float64 on a 256² Poisson operator: both
    run K2a; then CG with it, K2a launched on every slab product."""
    from stormx_torch.ops import dia as tdia
    from stormx_torch.sparse.formats import DIA

    nx = 256
    n = nx * nx
    i = np.arange(n)
    data = np.zeros((5, n))
    data[2] = 4.0
    data[0, i >= nx] = -1.0
    data[4, i < n - nx] = -1.0
    data[1, i % nx > 0] = -1.0
    data[3, i % nx < nx - 1] = -1.0
    dia = DIA(data=torch.as_tensor(data), offsets=(-nx, -1, 0, 1, nx), shape=(n, n))
    dev = nccl_mesh.device
    pdia = tpar.partition_dia(dia, 1, align=4, device=dev)
    amg = tpar.DistributedBlockDiaAmg(dia, pdia, group=4, device=dev)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(n), device=dev)
    before = tdia.launches["dia_spmv"]
    got = amg.make_apply(nccl_mesh)(v)
    assert tdia.launches["dia_spmv"] > before
    want = amg.serial(v)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    b = np.random.default_rng(5).standard_normal(n)
    opts = SolverOptions(num_iterations=200, absolute_tolerance=0.0, relative_tolerance=1e-8)
    before = tdia.launches["dia_spmv"]
    res = tpar.sharded_dia_solve(pdia, b, mesh=nccl_mesh, amg=amg, options=opts)
    assert res.converged and res.x.is_cuda
    assert tdia.launches["dia_spmv"] - before >= 3 * res.num_iterations


def test_sharded_bsr_p1_nccl_matches_serial(nccl_mesh):
    """``sharded_bsr_solve`` GMRES(30) with block-Jacobi at P = 1 under NCCL,
    both layouts, against the serial ``BSR`` solve on the card, float64."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import structured_tet_box
    from stormx_torch.precond import BlockJacobiPreconditioner
    from stormx_torch.solvers import gmres, make_operator
    from stormx_torch.sparse.formats import BSR

    dev = nccl_mesh.device
    ell = assemble_laplacian(structured_tet_box(6, 5, 4))
    data, cols = ell.data.numpy(), ell.cols.numpy()
    n, nv = data.shape[0], 4
    rng = np.random.default_rng(3)
    blocks = data[:, :, None, None] * (np.eye(nv) + 0.2)[None, None]
    c = 6.0 * np.eye(nv) + 0.8 * np.triu(rng.standard_normal((nv, nv)), 1)
    blocks += ((cols == np.arange(n)[:, None]) & (data != 0))[..., None, None] * c
    bsr = BSR(blocks=torch.as_tensor(blocks, device=dev), cols=torch.as_tensor(cols, device=dev),
              shape=(n * nv, n * nv))
    b = torch.as_tensor(rng.standard_normal(n * nv), device=dev)
    opts = SolverOptions(num_iterations=600, absolute_tolerance=1e-9, relative_tolerance=1e-9)
    serial = gmres(make_operator(bsr.matvec), b, torch.zeros_like(b), restart=30, orthog="cgs2",
                   precond=BlockJacobiPreconditioner(matrix=bsr), options=opts)
    assert serial.converged
    k = serial.num_iterations
    for part in (tpar.partition_bsr, tpar.partition_bsr_banded):
        res = tpar.sharded_bsr_solve(part(bsr, 1, device=dev), b, mesh=nccl_mesh, restart=30,
                                     options=opts, block_jacobi=True)
        assert res.converged and res.num_iterations == k, part.__name__
        np.testing.assert_allclose(res.history[: k + 1].cpu().numpy(),
                                   serial.history[: k + 1].cpu().numpy(), rtol=1e-10)
