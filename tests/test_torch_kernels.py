"""The CUDA kernels of stormx_torch against their plain PyTorch versions, on
the card.  Each test skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerances: K1 within 1e-5·max|y| (the kernel's FMA K-sum and torch's sum
differ in order); K3 bit-exact, in one launch per call; a float32 Cahn–Hilliard step on the card
within 1e-4 of the float64 CPU step on a 2,560-cell mesh (cond(A) ~1e5 there,
so float32 rounding of A moves the solution by ~1e-5).  K2a and K2b against
their plain versions: vectors within 1e-5·max (float32) or 1e-12·max
(float64) — the kernels fuse each product into an FMA — and dot products
within the same multiple of Σ|aᵢ·bᵢ|, since they are tree sums in another
order than ``torch.dot``.  K3 at the FVM widths (nv 5, 10, 15, float32
and float64), on strided fields through the plan, and inside an Euler
step, bit-identical to the same step with tensor indexing.  K4a and K4b (the packed SlicedELL) within
1e-5·max|y| of their plain version, which sums in another order, and with
Inf in x K4b's two branches non-finite in exactly the plain version's rows;
P1 and P2 bit-exact (both round in the plain version's order)."""

import numpy as np
import pytest
import torch

from stormx_torch.fvm.divgrad import assemble_laplacian
from stormx_torch.mesh import build_mesh, structured_tri_rect
from stormx_torch.ops import banded_gather, dia, probes, sell_packed, sell_spmv
from stormx_torch.ops.banded_gather import BandedGatherPlan
from stormx_torch.sparse.formats import CSR, DIA
from stormx_torch.sparse.windowed import auto_operator, sell_from_csr

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
    # many fixups, and m not a multiple of 4
    idx = np.sort(rng.integers(0, 5000, 11003))
    idx[::97] = rng.integers(0, 5000, len(idx[::97]))
    yield idx, 5000
    yield rng.integers(0, 5000, 3000), 5000
    yield np.sort(rng.integers(0, 5000, 127)), 5000
    yield np.array([4321]), 5000
    # a mesh's face → cell map (m = 2,552 faces) and its cell ← face ELL
    mesh = structured_tri_rect(40, 32).optimize_ordering()
    yield mesh.face_cells[:, 0], mesh.num_cells
    dm = mesh.device_arrays(torch.float32, device="cpu", banded_gather=False)
    yield dm.cell_face_ell.reshape(-1).numpy(), mesh.num_faces
    # a map wider than MAX_CHUNKS windows (the JAX plan's plain gather)
    yield rng.integers(0, 100_000, 20_000), 100_000


# (dtype, nv): the 4-byte nv = 1 case takes the kernel's 16-byte branch,
# every other one its scalar branch (complex128 as 2·nv 8-byte words).
GATHER_ROWS = [(np.float32, 1), (np.float32, 2), (np.int32, 3), (np.float64, 1),
               (np.float64, 3), (np.int16, 1), (np.int16, 2), (np.uint8, 1),
               (np.complex128, 1), (np.complex128, 2), (np.complex128, 3)]


@pytest.mark.parametrize("dtype,nv", GATHER_ROWS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_gather_kernel_bit_exact(cuda_device, dtype, nv):
    rng = np.random.default_rng(0)
    for idx, n in _gather_cases(rng):
        plan = BandedGatherPlan(idx, n, device=cuda_device)
        shape = (n,) if nv == 1 else (n, nv)
        x = (rng.standard_normal(shape) * 100).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            x += 1j * rng.standard_normal(shape)
        xt = torch.as_tensor(x, device=cuda_device)
        before = banded_gather.launches
        y = plan(xt)
        torch.cuda.synchronize()
        assert banded_gather.launches == before + 1
        assert torch.equal(y, banded_gather.banded_gather_plain(plan, xt))
        assert np.array_equal(y.cpu().numpy(), x[idx])


def _cuda_kernels_in(fn, attempts=5, calls=8):
    """The CUDA kernels of one call of ``fn``, from a torch.profiler trace of
    ``calls`` calls, each between two empty kernels a side.  A session now
    and then loses records (a whole session, its first records, a kernel
    between intact brackets), and a lost record only shortens a stretch, so
    the call's kernels are the longest stretch between empty kernels; a
    trace with none is taken again.  ``chip_smoke.cuda_kernels_in`` takes
    them so too."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                for _ in range(2):
                    banded_gather.empty_launch(1, dev)
                fn()
            for _ in range(2):
                banded_gather.empty_launch(1, dev)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        marks = [i for i, n in enumerate(names) if "empty_kernel" in n]
        stretches = [names[a + 1:b] for a, b in zip(marks, marks[1:]) if b > a + 1]
        if stretches:
            return max(stretches, key=len)
    raise AssertionError(f"{attempts} traces held no kernel between empty kernels: {names}")


def test_gather_kernel_is_one_launch_per_call(cuda_device):
    rng = np.random.default_rng(1)
    for idx, n in _gather_cases(rng):
        plan = BandedGatherPlan(idx, n, device=cuda_device)
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=cuda_device)
        names = _cuda_kernels_in(lambda: banded_gather.banded_gather_cuda(plan, x))
        assert len(names) == 1 and "banded_gather" in names[0], names


def test_gather_launch_count_holds_over_repeated_traces(cuda_device):
    rng = np.random.default_rng(7)
    for idx, n in list(_gather_cases(rng))[:2]:
        plan = BandedGatherPlan(idx, n, device=cuda_device)
        assert not plan.xla_fallback
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=cuda_device)
        for _ in range(10):
            names = _cuda_kernels_in(lambda: banded_gather.banded_gather_cuda(plan, x))
            assert len(names) == 1 and "banded_gather" in names[0], names


def test_gather_kernel_complex128_is_one_launch_per_call(cuda_device):
    rng = np.random.default_rng(6)
    idx, n = next(_gather_cases(rng))
    plan = BandedGatherPlan(idx, n, device=cuda_device)
    for shape in ((n,), (n, 3)):
        x = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                            device=cuda_device)
        names = _cuda_kernels_in(lambda: banded_gather.banded_gather_cuda(plan, x))
        assert len(names) == 1 and "banded_gather" in names[0], names
        assert torch.equal(plan(x), banded_gather.banded_gather_plain(plan, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("nv", [5, 10, 15])
def test_gather_kernel_fvm_widths(cuda_device, dtype, nv):
    """K3 at the FVM path's field widths (the conserved state, its 2-D and
    3-D gradients) on a mesh's four plans: bit-exact, one kernel a call."""
    mesh = structured_tri_rect(40, 32).optimize_ordering()
    dm = mesh.device_arrays(dtype, device=cuda_device, banded_gather=True)
    gen = torch.Generator().manual_seed(nv)
    for name in ("face_inner", "face_outer", "cell_face", "cell_adj"):
        plan = getattr(dm, "bg_" + name)
        x = torch.randn(plan.n_src, nv, generator=gen, dtype=dtype).to(cuda_device)
        before = plan.launches_by_shape[(nv, dtype)]
        y = plan(x)
        assert plan.launches_by_shape[(nv, dtype)] == before + 1
        assert torch.equal(y, banded_gather.banded_gather_plain(plan, x))
        assert torch.equal(y, x[banded_gather.decode_word(plan)])
        names = _cuda_kernels_in(lambda: banded_gather.banded_gather_cuda(plan, x))
        assert len(names) == 1 and "banded_gather" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_gather_dispatcher_takes_transposed_and_column_views(cuda_device, dtype):
    """The plan takes any strided field, as the JAX plan takes any array: a
    transposed (n, nv) and a column view gather bit-exact, in one launch."""
    mesh = structured_tri_rect(40, 32).optimize_ordering()
    plan = mesh.device_arrays(dtype, device=cuda_device, banded_gather=True).bg_face_inner
    xt = torch.randn(5, plan.n_src, dtype=dtype, device=cuda_device).t()
    assert not xt.is_contiguous()
    before = banded_gather.launches
    assert torch.equal(plan(xt), xt[banded_gather.decode_word(plan)])
    assert torch.equal(plan(xt[:, 2]), xt[:, 2][banded_gather.decode_word(plan)])
    assert banded_gather.launches == before + 2
    with pytest.raises(ValueError, match="contiguous"):
        banded_gather.banded_gather_cuda(plan, xt)


@pytest.mark.parametrize("order", [1, 2])
def test_euler_step_on_card_through_k3(cuda_device, order):
    """A forward-Euler step on the card with K3's plans is bit-identical to
    the same step with tensor indexing, and launches K3 3 (order 1) or 11
    (order 2) times."""
    from stormx_torch.apps.euler import initial_state
    from stormx_torch.fvm import FvSolver, slip_bc

    mesh = structured_tri_rect(40, 32).optimize_ordering()
    dm_k3 = mesh.device_arrays(torch.float32, device=cuda_device)
    dm_idx = mesh.device_arrays(torch.float32, device=cuda_device, banded_gather=False)
    assert dm_k3.bg_cell_adj is not None and dm_idx.bg_cell_adj is None
    u0 = initial_state(mesh.num_cells, device=cuda_device)
    u0 = u0 * (1.0 + 0.05 * torch.rand(u0.shape, generator=torch.Generator().manual_seed(0))
               .to(cuda_device))
    bcs = {1: slip_bc}
    before = banded_gather.launches
    y_k3 = FvSolver(dm_k3, order=order, bcs=bcs).step(u0, 1e-3)
    assert banded_gather.launches == before + {1: 3, 2: 11}[order]
    y_idx = FvSolver(dm_idx, order=order, bcs=bcs).step(u0, 1e-3)
    assert torch.equal(y_k3, y_idx)


def test_euler_step_on_card_through_k3_on_wide_maps(cuda_device):
    """On a tetrahedral box whose cell←face map is wider than MAX_CHUNKS
    windows (the JAX plan gathers it plainly), a 2nd-order step still
    launches K3 for all 11 of its gathers, bit-identical to the same step
    with tensor indexing."""
    from stormx_torch.apps.euler import initial_state
    from stormx_torch.fvm import FvSolver, slip_bc
    from stormx_torch.mesh import structured_tet_box

    mesh = structured_tet_box(12, 12, 12).optimize_ordering()
    dm_k3 = mesh.device_arrays(torch.float32, device=cuda_device)
    dm_idx = mesh.device_arrays(torch.float32, device=cuda_device, banded_gather=False)
    assert dm_k3.bg_cell_face.xla_fallback
    u0 = initial_state(mesh.num_cells, device=cuda_device)
    u0 = u0 * (1.0 + 0.05 * torch.rand(u0.shape, generator=torch.Generator().manual_seed(0))
               .to(cuda_device))
    before = banded_gather.launches
    y_k3 = FvSolver(dm_k3, bcs={1: slip_bc}).step(u0, 1e-3)
    assert banded_gather.launches == before + 11
    assert dm_k3.bg_cell_face.launches == 2
    assert torch.equal(y_k3, FvSolver(dm_idx, bcs={1: slip_bc}).step(u0, 1e-3))


def test_gather_plan_defaults_to_the_card(cuda_device):
    plan = BandedGatherPlan(np.sort(np.random.default_rng(2).integers(0, 900, 2000)), 900)
    assert plan.word.is_cuda and plan.word_starts.is_cuda and plan.lidx.is_cuda


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


# K2a shapes: aligned and unaligned offsets, ragged n, a single diagonal,
# and an offset beyond n/2.
DIA_CASES = [
    (4096, (-128, -1, 0, 1, 128)),
    (4096, (-130, -7, 0, 3, 257)),
    (5000, (-64, 0, 64)),
    (1024, (0,)),
    (3000, (-2000, 0, 1700)),
]
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _dia(n, offsets, dtype, device, seed=0):
    # Every stored entry is non-zero, outside the band too: both versions
    # must ignore the entries whose column falls outside [0, n).
    data = np.random.default_rng(seed).standard_normal((len(offsets), n))
    return DIA(data=torch.as_tensor(data, dtype=dtype, device=device),
               offsets=tuple(offsets), shape=(n, n))


def _close(got, want, tol):
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("n,offsets", DIA_CASES)
def test_dia_spmv_kernel_matches_plain_version(cuda_device, dtype, n, offsets):
    a = _dia(n, offsets, dtype, cuda_device)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n), dtype=dtype,
                        device=cuda_device)
    before = dict(dia.launches)
    z_k = a.matvec(x)
    z_d, pz_d = dia.dia_spmv_dots(a, x)
    torch.cuda.synchronize()
    assert dia.launches["dia_spmv"] == before["dia_spmv"] + 1
    assert dia.launches["dia_spmv_dots"] == before["dia_spmv_dots"] + 1
    z_p, pz_p = dia.dia_spmv_dots_plain(a, x)
    assert _close(z_k, z_p, RTOL[dtype]) and _close(z_d, z_p, RTOL[dtype])
    assert abs(float(pz_d - pz_p)) <= RTOL[dtype] * float((x * z_p).abs().sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("n", [3000, (1 << 20) + 17])
def test_cg_update_kernel_matches_plain_version(cuda_device, dtype, n):
    rng = np.random.default_rng(3)
    x, r, p, z = (torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=cuda_device)
                  for _ in range(4))
    alpha = torch.tensor(0.37, dtype=dtype, device=cuda_device)
    before = dia.launches["cg_fused_update"]
    x_k, r_k, rr_k = dia.cg_fused_update(alpha, x, r, p, z)
    torch.cuda.synchronize()
    assert dia.launches["cg_fused_update"] == before + 1
    x_p, r_p, rr_p = dia.cg_fused_update_plain(alpha, x, r, p, z)
    assert _close(x_k, x_p, RTOL[dtype]) and _close(r_k, r_p, RTOL[dtype])
    assert abs(float(rr_k - rr_p)) <= RTOL[dtype] * float(rr_p)
    x_n, _, _ = dia.cg_fused_update(0.37, x, r, p, z)  # α given as a number
    assert torch.equal(x_n, x_k)


def _spd_banded(n, dtype, device):
    offsets = (-128, -1, 0, 1, 128)
    data = np.zeros((5, n))
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        data[d, lo:hi] = 4.0 if off == 0 else -0.9
    return DIA(data=torch.as_tensor(data, dtype=dtype, device=device), offsets=offsets,
               shape=(n, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_cg_step_kernels_match_plain_versions(cuda_device, dtype):
    n = 100_000
    a_gpu, a_cpu = _spd_banded(n, dtype, cuda_device), _spd_banded(n, dtype, "cpu")
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(n), dtype=dtype)
    states = {}
    for name, a in (("kernel", a_gpu), ("plain", a_cpu)):
        r = b.to(a.data.device)
        x, p, gamma = torch.zeros_like(r), r.clone(), torch.dot(r, r)
        for _ in range(10):
            x, r, p, gamma = dia.cg_step(a, x, r, p, gamma)
        states[name] = [t.cpu() for t in (x, r, p, gamma)]
    # float32: ten iterations carry the roundoff of both versions along.
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for k, c in zip(states["kernel"], states["plain"]):
        assert _close(k, c, tol)
    assert float(states["kernel"][3]) < 1e-3 * float(b @ b)


def test_dia_matvec_on_card_raises_instead_of_falling_back(cuda_device):
    a = _dia(4096, (-128, -1, 0, 1, 128), torch.float32, cuda_device)
    x = torch.ones(4096, dtype=torch.float64, device=cuda_device)
    before = dict(dia.launches)
    with pytest.raises(ValueError, match="dtype"):
        a.matvec(x)
    with pytest.raises(ValueError):
        a.matvec(torch.ones(8192, dtype=torch.float32, device=cuda_device)[::2])
    with pytest.raises(ValueError):
        dia.cg_fused_update(0.5, x, x, x, x.float())
    assert dia.launches == before


@pytest.mark.parametrize("variant", sell_packed.VARIANTS)
@pytest.mark.parametrize("block_rows", [128, 512])
def test_packed_kernels_match_plain_version(cuda_device, block_rows, variant):
    mesh, csr = _delaunay_laplacian()
    n = csr.shape[0]
    assert n % block_rows, "the last block must end in padding rows"
    sell, _ = sell_from_csr(csr, block_rows=block_rows, mode="cuda", coords=mesh.cell_centers,
                            device=cuda_device)
    packed = sell_packed.pack_sell(sell, variant)
    assert packed.idx.is_cuda and packed.sub == block_rows // 128
    if variant == "gather":
        assert sell_packed.gather_branch(packed) == "staged"
    # K4a reads no tile row at or past rows_used: some block must end early.
    assert bool((packed.rows_used < packed.vals.shape[1]).any())
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(n), dtype=torch.float32,
                        device=cuda_device)
    before = dict(sell_packed.launches)
    y_k = packed.matvec(x)
    torch.cuda.synchronize()
    assert sell_packed.launches[variant] == before[variant] + 1
    y_p = sell_packed.packed_spmv_plain(packed, x)
    assert _close(y_k, y_p, 1e-5)
    assert _close(y_k, sell_spmv.sell_spmv_plain(sell, x), 1e-5)
    with pytest.raises(ValueError):
        sell_packed.packed_spmv_cuda(packed, x.double())


def _random_banded_csr(n, k, band, seed=0):
    """A float32 CSR whose rows hold k entries within ``band`` of the
    diagonal, every seventh row only k // 2 (dead entries of K4b)."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n):
        near = np.arange(max(0, i - band), min(n, i + band + 1))
        cols.append(np.sort(rng.choice(near, k if i % 7 else k // 2, replace=False)))
    lengths = np.array([len(c) for c in cols])
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    data = rng.standard_normal(row_ptr[-1]).astype(np.float32)
    return CSR(data=torch.as_tensor(data), indices=torch.as_tensor(np.concatenate(cols)),
               row_ptr=torch.as_tensor(row_ptr), shape=(n, n))


# K4b's branches: (n, K, band, R, the branch the wrapper picks).  K = 10 is
# the Cahn–Hilliard operator's width (an unrolled K-sum), K = 13 takes the
# K-sum of any width; at R = 2048 and K = 32, M ≥ sub·K = 512 tile rows,
# whose products (266 KB) exceed a block's shared memory.
GATHER_BRANCH_CASES = {
    "k10": (12_000, 10, 200, 512, "staged"),
    "k13": (12_000, 13, 200, 512, "staged"),
    "over_budget": (5_000, 32, 300, 2048, "rows"),
}


def _nonfinite(y):
    return torch.nonzero(~torch.isfinite(y)).reshape(-1).cpu()


@pytest.mark.parametrize("case", sorted(GATHER_BRANCH_CASES))
def test_packed_gather_branches_match_plain_version(cuda_device, case):
    n, k, band, block_rows, branch = GATHER_BRANCH_CASES[case]
    csr = _random_banded_csr(n, k, band)
    sell, _ = sell_from_csr(csr, block_rows=block_rows, mode="cuda", reorder=False,
                            device=cuda_device)
    packed = sell_packed.pack_sell(sell, "gather")
    assert packed.ell_k == k and sell_packed.gather_branch(packed) == branch
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(n), dtype=torch.float32,
                        device=cuda_device)
    before = sell_packed.launches["gather"]
    y_k = packed.matvec(x)
    torch.cuda.synchronize()
    assert sell_packed.launches["gather"] == before + 1
    y_p = sell_packed.packed_spmv_plain(packed, x)
    assert _close(y_k, y_p, 1e-5)
    assert _close(y_k, sell_spmv.sell_spmv_plain(sell, x), 1e-5)
    branches = ("staged", "rows") if branch == "staged" else ("rows",)
    if branch == "rows":
        with pytest.raises(ValueError, match="shared memory"):
            sell_packed.packed_spmv_cuda(packed, x, branch="staged")
    # Inf at x[3] and at block 1's window start, where the dead entries
    # (tile row M − 1) read: each branch is non-finite in the plain version's
    # rows, the dead entries' 0·Inf included.
    for pos in (3, block_rows - packed.pad_lo):
        xi = x.clone()
        xi[pos] = float("inf")
        want = _nonfinite(sell_packed.packed_spmv_plain(packed, xi))
        assert want.numel() > 0
        for b in branches:
            got = _nonfinite(sell_packed.packed_spmv_cuda(packed, xi, branch=b))
            assert torch.equal(got, want), (b, pos)
    if branch == "staged":
        assert _close(sell_packed.packed_spmv_cuda(packed, x, branch="rows"), y_p, 1e-5)


@pytest.mark.parametrize("variant", sell_packed.VARIANTS)
def test_packed_jvp_on_card_and_backward_raises(cuda_device, variant):
    mesh, csr = _delaunay_laplacian()
    sell, _ = sell_from_csr(csr, block_rows=512, mode="cuda", coords=mesh.cell_centers,
                            device=cuda_device)
    packed = sell_packed.pack_sell(sell, variant)
    rng = np.random.default_rng(3)
    x, t = (torch.as_tensor(rng.standard_normal(csr.shape[0]), dtype=torch.float32,
                            device=cuda_device) for _ in range(2))
    before = sell_packed.launches[variant]
    y, dy = torch.func.jvp(packed.matvec, (x,), (t,))
    torch.cuda.synchronize()
    assert sell_packed.launches[variant] == before + 2  # the primal and the tangent
    assert torch.equal(y, packed.matvec(x))
    assert torch.equal(dy, packed.matvec(t))
    with pytest.raises(NotImplementedError, match="transpose"):
        packed.matvec(x.clone().requires_grad_()).sum().backward()


def test_lane_gather_kernel_bit_exact(cuda_device):
    rng = np.random.default_rng(4)
    for rows in (16, 1000, 74_640):
        x = torch.as_tensor(rng.standard_normal((rows, 128)), dtype=torch.float32,
                            device=cuda_device)
        idx = torch.as_tensor(rng.integers(0, 128, (rows, 128)), dtype=torch.int32,
                              device=cuda_device)
        before = probes.launches["lane_gather"]
        y = probes.lane_gather(x, idx)
        torch.cuda.synchronize()
        assert probes.launches["lane_gather"] == before + 1
        assert torch.equal(y, probes.lane_gather_plain(x, idx))


@pytest.mark.parametrize("mode", probes.STREAM_MODES)
def test_dia_stream_probe_kernel_matches_plain_version(cuda_device, mode):
    rng = np.random.default_rng(5)
    n = 32 * 1024 * 128 + 384  # ragged against the grid
    diag = torch.as_tensor(rng.standard_normal((5, n)), dtype=torch.float32, device=cuda_device)
    x = torch.as_tensor(rng.standard_normal(n + probes.X_HALO), dtype=torch.float32,
                        device=cuda_device)
    before = probes.launches["dia_stream_probe"]
    z = probes.dia_stream_probe(mode, 0.3125, x, diag)
    torch.cuda.synchronize()
    assert probes.launches["dia_stream_probe"] == before + 1
    assert torch.equal(z, probes.dia_stream_probe_plain(mode, 0.3125, x, diag))


def _diffusion_on_card(cuda_device):
    """K1's operator of the implicit diffusion step V + 0.1·L on a structured
    mesh (an SPD M-matrix; float32 products of the singular Laplacian's
    smooth modes are too inexact for AMG's comparison) and its float32 CSR in
    the same (permuted) numbering, from which the preconditioners are
    built."""
    from stormx_torch.sparse.windowed import _permuted_csr

    mesh = structured_tri_rect(70, 60).optimize_ordering()
    lap = assemble_laplacian(mesh).to_csr()
    rows = np.repeat(np.arange(mesh.num_cells), np.diff(lap.row_ptr.numpy()))
    vals = 0.1 * lap.data.numpy() + np.where(lap.indices.numpy() == rows,
                                             mesh.cell_volumes[rows], 0.0)
    csr = CSR(data=torch.as_tensor(vals, dtype=torch.float32), indices=lap.indices,
              row_ptr=lap.row_ptr, shape=lap.shape)
    op, perm = auto_operator(csr, coords=mesh.cell_centers, device=cuda_device)
    assert op.mode == "cuda"
    pcsr, _ = _permuted_csr(csr, perm)
    return op, pcsr


@pytest.mark.parametrize("sweeps", [1, 2])
def test_amg_fine_level_through_k1(cuda_device, sweeps):
    """AMG with ``fine_matvec`` = K1 equals its ELL route to float32
    roundoff (1e-5 relative), and launches K1 2·num_sweeps + 1 times per
    V-cycle."""
    from stormx_torch.precond import AmgPreconditioner

    op, pcsr = _diffusion_on_card(cuda_device)
    kw = dict(num_sweeps=sweeps, dtype=torch.float32, device=cuda_device)
    routed = AmgPreconditioner(pcsr, fine_matvec=op.matvec, **kw)
    ell = AmgPreconditioner(pcsr, **kw)
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(pcsr.shape[0]),
                        dtype=torch.float32, device=cuda_device)
    before = sell_spmv.launches
    z = routed(r)
    torch.cuda.synchronize()
    assert sell_spmv.launches - before == 2 * sweeps + 1
    assert z.dtype == torch.float32 and z.device == r.device
    assert _close(z, ell(r), 1e-5)


def test_chebyshev_through_k1(cuda_device):
    """Chebyshev's power iteration and apply through K1 equal the same on the
    plain operator, with ``power_iters`` and ``degree`` K1 launches."""
    from stormx_torch.precond import ChebyshevPreconditioner

    op, _ = _diffusion_on_card(cuda_device)
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(op.shape[0]),
                        dtype=torch.float32, device=cuda_device)
    before = sell_spmv.launches
    cheb = ChebyshevPreconditioner(4).build(None, b, op.matvec)
    assert sell_spmv.launches - before == 10
    plain = ChebyshevPreconditioner(4).build(
        None, b, lambda x: sell_spmv.sell_spmv_plain(op, x))
    assert abs(float(cheb._lmax) - float(plain._lmax)) <= 1e-5 * float(plain._lmax)
    before = sell_spmv.launches
    z = cheb(b)
    torch.cuda.synchronize()
    assert sell_spmv.launches - before == 4
    assert _close(z, plain(b), 1e-4)


@pytest.mark.parametrize("sweeps", [None, 3])
def test_tri_solve_on_card_matches_cpu(cuda_device, sweeps):
    """IC(0)'s two triangular solves on the card equal the CPU's in float32
    (within 1e-6 relative)."""
    from stormx_torch.precond import IcPreconditioner, tri_solve

    _, pcsr = _diffusion_on_card(cuda_device)
    card = IcPreconditioner(pcsr, sweeps=sweeps, device=cuda_device)
    cpu = IcPreconditioner(pcsr, sweeps=sweeps, device="cpu")
    r = np.random.default_rng(8).standard_normal(pcsr.shape[0])
    rc = torch.as_tensor(r, dtype=torch.float32)
    for tri_card, tri_cpu in ((card._first, cpu._first), (card._second, cpu._second)):
        got = tri_solve(tri_card, rc.to(cuda_device), sweeps=sweeps).cpu()
        assert _close(got, tri_solve(tri_cpu, rc, sweeps=sweeps), 1e-6)
    assert _close(card(rc.to(cuda_device)).cpu(), cpu(rc), 1e-6)


def test_bsr_and_block_jacobi_on_card(cuda_device):
    from stormx_torch.precond import BlockJacobiPreconditioner
    from stormx_torch.sparse import bsr_from_csr

    _, pcsr = _diffusion_on_card(cuda_device)
    for b in (2, 3):
        n = pcsr.shape[0] - pcsr.shape[0] % b
        rows = np.repeat(np.arange(pcsr.shape[0]), np.diff(pcsr.row_ptr))
        keep = (rows < n) & (pcsr.indices < n)
        rp = np.zeros(n + 1, dtype=np.int64)
        np.add.at(rp, rows[keep] + 1, 1)
        sub = CSR(data=torch.as_tensor(pcsr.data[keep]),
                  indices=torch.as_tensor(pcsr.indices[keep]),
                  row_ptr=torch.as_tensor(np.cumsum(rp).astype(np.int32)), shape=(n, n))
        cpu = bsr_from_csr(sub, b)
        card = bsr_from_csr(CSR(data=sub.data.to(cuda_device),
                                indices=sub.indices.to(cuda_device),
                                row_ptr=sub.row_ptr.to(cuda_device), shape=(n, n)), b)
        assert card.blocks.device == sub.data.to(cuda_device).device
        x = torch.as_tensor(np.random.default_rng(9).standard_normal(n), dtype=torch.float32)
        assert _close(card.matvec(x.to(cuda_device)).cpu(), cpu.matvec(x), 1e-6)
        bj_card = BlockJacobiPreconditioner(matrix=card)
        bj_cpu = BlockJacobiPreconditioner(matrix=cpu)
        assert _close(bj_card(x.to(cuda_device)).cpu(), bj_cpu(x), 1e-5)


def _bits(t):
    r = torch.view_as_real(t).contiguous()
    return r.view(torch.int64 if r.dtype == torch.float64 else torch.int32)


def test_gather_kernel_complex64_is_one_launch_per_call(cuda_device):
    """complex64 takes K3's 8-byte scalar branch: bit-exact, one kernel."""
    rng = np.random.default_rng(12)
    idx, n = next(_gather_cases(rng))
    plan = BandedGatherPlan(idx, n, device=cuda_device)
    for shape in ((n,), (n, 3)):
        x = torch.as_tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64, device=cuda_device)
        names = _cuda_kernels_in(lambda: banded_gather.banded_gather_cuda(plan, x))
        assert len(names) == 1 and "banded_gather" in names[0], names
        assert torch.equal(_bits(plan(x)), _bits(banded_gather.banded_gather_plain(plan, x)))
        assert torch.equal(_bits(plan(x)), _bits(x[torch.as_tensor(idx, device=cuda_device)]))


def test_complex128_gmres_on_a_k3_div_grad(cuda_device):
    """GMRES on (1 + 0.5i)I − τΔ through K3's plans on the card, against the
    same solve on the CPU (histories within 1e-10 relative, equal counts)."""
    from stormx_torch.fvm.divgrad import div_grad
    from stormx_torch.solvers import SolverOptions, gmres, make_operator

    mesh = structured_tri_rect(40, 32).optimize_ordering()
    rng = np.random.default_rng(3)
    b = rng.standard_normal(mesh.num_cells) + 1j * rng.standard_normal(mesh.num_cells)
    opts = SolverOptions(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-10)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        dm = mesh.device_arrays(torch.float64, device=dev, banded_gather=True)
        op = make_operator(lambda c, dm=dm: div_grad(dm, (1 + 0.5j) * c, -1e-3, c))
        k3 = banded_gather.launches
        bt = torch.as_tensor(b, device=dev)
        out[dev.type] = gmres(op, bt, torch.zeros_like(bt), options=opts)
        if dev.type == "cuda":
            assert banded_gather.launches - k3 >= 3 * out["cuda"].num_iterations
    g, c = out["cuda"], out["cpu"]
    assert g.converged and g.num_iterations == c.num_iterations
    assert not g.history.is_complex()
    k = g.num_iterations
    np.testing.assert_allclose(g.history[: k + 1].cpu().numpy(), c.history[: k + 1].numpy(),
                               rtol=1e-10, atol=1e-13 * float(c.history[0]))


def test_checked_catches_an_out_of_range_gather_on_the_card(cuda_device):
    """The bounds are checked before the gather is dispatched, so no
    device-side assert fires and the context stays usable."""
    from stormx_torch.core import checked

    x = torch.arange(10, dtype=torch.float32, device=cuda_device)
    bad = torch.tensor([1, 10], device=cuda_device)
    for fn in (lambda v: v[bad], lambda v: torch.index_select(v, 0, bad),
               lambda v: torch.gather(v, 0, bad), lambda v: torch.take(v, bad)):
        err, out = checked(fn)(x)
        assert "out-of-bounds" in err.get()
        assert out.tolist() == [1.0, 9.0]
    rng = np.random.default_rng(2)
    idx, n = next(_gather_cases(rng))
    plan = BandedGatherPlan(idx, n, device=cuda_device)
    y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=cuda_device)
    assert torch.equal(plan(y), banded_gather.banded_gather_plain(plan, y))
    torch.cuda.synchronize()


def test_segment_sum_is_deterministic_on_the_card(cuda_device):
    from stormx_torch.core import assert_deterministic
    from stormx_torch.ops import segment_sum

    gen = torch.Generator(device="cpu").manual_seed(4)
    data = torch.randn(1 << 20, generator=gen).to(cuda_device)
    ids = torch.randint(0, 1024, (1 << 20,), generator=gen).to(cuda_device)
    assert_deterministic(segment_sum, data, ids, 1024, runs=4)
    # The card sums in another order than the CPU: within float32 rounding
    # of the float64 sums (n·ε·Σ|x| bounds it at ~6e-5·Σ|x| for 1,024
    # entries a segment).
    want = torch.zeros(1024, dtype=torch.float64).index_add_(0, ids.cpu(), data.double().cpu())
    scale = torch.zeros(1024, dtype=torch.float64).index_add_(0, ids.cpu(), data.double().abs().cpu())
    got = segment_sum(data, ids, 1024).double().cpu()
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


def test_assembled_step_is_deterministic_on_the_card(cuda_device):
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.core import assert_deterministic
    from stormx_torch.solvers import SolverOptions

    mesh = structured_tri_rect(40, 32).optimize_ordering()
    opts = SolverOptions(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-6)
    step = make_assembled_step(mesh, options=opts, dtype=torch.float32, device=cuda_device)
    c0 = torch.as_tensor(0.5 + 0.1 * np.random.default_rng(0).standard_normal(mesh.num_cells),
                         dtype=torch.float32, device=cuda_device)
    assert_deterministic(lambda: step(c0)[0], runs=3)
