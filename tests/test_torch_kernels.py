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
order than ``torch.dot``.  K3 at the FVM widths (nv 2–5, 10, 15, float32
and float64; complex64 and complex128), on fields at an odd offset, through
every branch that takes a field, on strided fields through the plan, and
inside an Euler step, bit-identical to the same step with tensor indexing.  K4a and K4b (the packed SlicedELL) within
1e-5·max|y| of their plain version, which sums in another order, and with
Inf in x K4b's two branches non-finite in exactly the plain version's rows;
P1 and P2 bit-exact (both round in the plain version's order).  T1 and T2
(the triangular solve) bit-exact in float32 and float64, within 4 ulp of
max|y| in complex, one T1 launch per exact solve and one T2 launch per
sweep; T1's errors raise instead of hanging.  CG run as replays of a
captured CUDA graph (``solvers/base.py``) bit for bit equal to the eager
loop, on K1 "staged" in float32 and on K2a in float64, with launch counters
that count the replayed kernels, results that outlive the next solve, and
an IC(0) solve that T1 sends back to the eager loop."""

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


def _banded_sell(n, K, band, R, seed, device):
    """A float32 SlicedELL of up to K entries a row within ``band`` of the
    diagonal (every seventh row cut to K // 2 + 1: padding slots)."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(-band, band + 1, size=(n, K))
    offs[:, 0] = 0
    cols = np.sort(np.arange(n)[:, None] + offs, axis=1)
    keep = (cols >= 0) & (cols < n)
    keep[:, 1:] &= cols[:, 1:] != cols[:, :-1]
    keep[::7, K // 2 + 1:] = False
    row_ptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(np.int32)
    csr = CSR(data=rng.standard_normal(int(row_ptr[-1])).astype(np.float32),
              indices=cols[keep].astype(np.int32), row_ptr=row_ptr, shape=(n, n))
    return sell_from_csr(csr, block_rows=R, mode="cuda", reorder=False, device=device)[0]


def _slab_range(op, lo, hi):
    """Blocks [lo, hi) of ``op`` as the slab product's rectangular K1
    operator (a view at pad_lo 0 over the x its windows read)."""
    from stormx_torch.sparse.windowed import SlicedELL

    R, C = op.block_rows, op.window
    return SlicedELL(data=op.data[lo:hi], local_cols=op.local_cols[lo:hi],
                     shape=((hi - lo) * R, (hi - lo - 1) * R + C), window=C, pad_lo=0,
                     mode="cuda", dense_blocks=None)


# name -> (n, K, band, R, block range or None): a CH-like operator whose
# window starts below its block (pad_lo = 1,400 > R), K = 4, K = 1, K = 17
# (the runtime-K instantiation), one block, fewer rows than R, and a R = 512
# slab's interior, head and tail ranges.
K1_CASES = {
    "ch_like": (40_000, 10, 1400, 128, None),
    "k4": (40_000, 4, 300, 128, None),
    "k1": (40_000, 1, 0, 128, None),
    "k17": (40_000, 17, 500, 128, None),
    "one_block": (100, 6, 20, 128, None),
    "n_under_r": (50, 5, 10, 128, None),
    "slab_interior": (80_000, 10, 900, 512, (2, -3)),
    "slab_head": (80_000, 10, 900, 512, (0, 2)),
    "slab_tail": (80_000, 10, 900, 512, (-3, None)),
}


def _f32_bits(y):
    return y.view(torch.int32)


@pytest.mark.parametrize("case", list(K1_CASES))
def test_sell_staged_equals_rows_bit_for_bit(cuda_device, case):
    """K1's staged branch gives y bit for bit as "rows" does, also with Inf
    in x where padding slots read it (NaN in the same rows), and the
    launches count by branch."""
    n, K, band, R, blocks = K1_CASES[case]
    op = _banded_sell(n, K, band, R, seed=len(case), device=cuda_device)
    if blocks is not None:
        nb = op.data.shape[0]
        lo, hi = blocks
        op = _slab_range(op, lo % nb, nb if hi is None else hi % nb)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(op.shape[1]), dtype=torch.float32,
                        device=cuda_device)
    before = dict(sell_spmv.branch_launches)
    y_rows = sell_spmv.sell_spmv_cuda(op, x, branch="rows")
    y_staged = sell_spmv.sell_spmv_cuda(op, x, branch="staged")
    assert sell_spmv.branch_launches == dict(staged=before["staged"] + 1,
                                             rows=before["rows"] + 1)
    assert torch.equal(_f32_bits(y_staged), _f32_bits(y_rows))
    y_p = sell_spmv.sell_spmv_plain(op, x)
    assert float((y_staged - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    # x as a view one float into its storage: the staged windows' 16-byte
    # aligned copies start below x[0]
    for shift in (1, 3):
        x_view = torch.empty(op.shape[1] + shift, dtype=torch.float32,
                             device=cuda_device)[shift:]
        x_view.copy_(x)
        assert torch.equal(_f32_bits(sell_spmv.sell_spmv_cuda(op, x_view, branch="staged")),
                           _f32_bits(y_rows))
    # Inf at x[R·b − pad_lo] of every block b whose rows hold padding
    nb, _, R = op.data.shape
    padded = (op.data == 0).any(dim=1).any(dim=1).nonzero().reshape(-1)
    g = padded * R - op.pad_lo
    g = g[(g >= 0) & (g < op.shape[1])]
    x[g] = float("inf")
    y_rows = sell_spmv.sell_spmv_cuda(op, x, branch="rows")
    y_staged = sell_spmv.sell_spmv_cuda(op, x, branch="staged")
    y_p = sell_spmv.sell_spmv_plain(op, x)
    assert torch.equal(_f32_bits(y_staged), _f32_bits(y_rows))
    assert torch.equal(~torch.isfinite(y_staged), ~torch.isfinite(y_p))
    assert bool((~torch.isfinite(y_p)).any()) == bool(g.numel())


def test_sell_branch_rule_on_the_card(cuda_device):
    """The default launch takes the branch ``k1_branch`` names and counts
    it; an operator with two blocks for every SM takes "staged" at K = 10,
    "rows" at K = 4 and with one block."""
    big = _banded_sell(40_000, 10, 1400, 128, seed=0, device=cuda_device)
    big_k4 = _banded_sell(40_000, 4, 300, 128, seed=3, device=cuda_device)
    small = _banded_sell(100, 6, 20, 128, seed=1, device=cuda_device)
    for op, want in ((big, "staged"), (big_k4, "rows"), (small, "rows")):
        assert sell_spmv.branch_of(op) == want
        x = torch.ones(op.shape[1], dtype=torch.float32, device=cuda_device)
        before, total = dict(sell_spmv.branch_launches), sell_spmv.launches
        op.matvec(x)
        assert sell_spmv.launches == total + 1
        assert sell_spmv.branch_launches[want] == before[want] + 1
    with pytest.raises(ValueError, match="opt-in limit"):
        wide = _banded_sell(4096, 64, 100, 512, seed=2, device=cuda_device)
        sell_spmv.sell_spmv_cuda(wide, torch.ones(4096, device=cuda_device), branch="staged")


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


# (dtype, nv, offset): x starts ``offset`` elements into its storage (0:
# aligned; 1: a contiguous field at an odd offset, so the vector branch
# moves narrower vectors).  The 4-byte nv = 1 case takes the kernel's
# "vec4" branch, rows of 8 bytes or more its "vector" branch (complex128 as
# 2·nv 8-byte words), the rest its "scalar" branch (k3_branch); every
# branch that takes a case is held to the same bits.
GATHER_ROWS = ([(np.float32, 1, 0), (np.int32, 3, 0), (np.float64, 1, 0), (np.float64, 3, 0),
                (np.int16, 1, 0), (np.int16, 2, 0), (np.uint8, 1, 0), (np.complex128, 1, 0),
                (np.complex128, 3, 0), (np.int32, 4, 0)]
               + [(dt, nv, 0) for dt in (np.float32, np.float64) for nv in (2, 3, 4, 5, 10, 15)]
               + [(dt, nv, 0) for dt in (np.complex64, np.complex128) for nv in (2, 5)]
               + [(np.float32, 4, 1), (np.float32, 10, 1), (np.float64, 2, 1),
                  (np.float64, 5, 1), (np.complex64, 5, 1)])


@pytest.mark.parametrize("dtype,nv,offset", GATHER_ROWS,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_gather_kernel_bit_exact(cuda_device, dtype, nv, offset):
    rng = np.random.default_rng(0)
    for idx, n in _gather_cases(rng):  # the last map is wider than MAX_CHUNKS windows
        plan = BandedGatherPlan(idx, n, device=cuda_device)
        shape = (n,) if nv == 1 else (n, nv)
        x = (rng.standard_normal(shape) * 100).astype(dtype)
        if np.issubdtype(dtype, np.complexfloating):
            x += 1j * rng.standard_normal(shape)
        storage = torch.empty(x.size + offset, dtype=torch.as_tensor(x[:0]).dtype,
                              device=cuda_device)
        xt = storage[offset:].view(shape)
        xt.copy_(torch.as_tensor(x))
        assert xt.is_contiguous()
        path = banded_gather.branch_of(plan, xt)
        before = banded_gather.launches
        by_branch = dict(banded_gather.branch_launches)
        y = plan(xt)
        torch.cuda.synchronize()
        assert banded_gather.launches == before + 1
        assert banded_gather.branch_launches[path] == by_branch[path] + 1
        assert torch.equal(y, banded_gather.banded_gather_plain(plan, xt))
        assert np.array_equal(y.cpu().numpy(), x[idx])
        taken = 0
        for branch in banded_gather.BRANCHES:
            try:
                yb = banded_gather.banded_gather_cuda(plan, xt, branch=branch)
            except ValueError:
                continue
            torch.cuda.synchronize()
            taken += 1
            assert torch.equal(yb, y), branch
        assert taken >= 2 or path == "scalar"


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
        # The program's spans (record_function) come back as device-side
        # annotations too; they are not kernels.
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
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


# -- T1 and T2, the triangular solve's kernels ---------------------------------


def _to_card(tri, dev):
    """The factor on the card."""
    return type(tri)(*(t.to(dev) for t in tri))


def _chain(n, seed):
    """A lower bidiagonal factor: row i reads row i − 1, so n levels."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = np.concatenate([1.0 + rng.random(n), -0.9 * rng.random(n - 1)])
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True,
                            device="cpu")


def _against_order(n, seed):
    """An upper factor whose rows are solved against their index order: row
    i reads rows i + 1 and i + 3, so the levels run n − 1, n − 2, ..., 0."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for j, v in ((i, 2.0 + rng.random()), (i + 1, rng.standard_normal()),
                     (i + 3, rng.standard_normal())):
            if j < n:
                rows.append(i), cols.append(j), vals.append(v)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, np.asarray(rows) + 1, 1)
    return build_triangular(np.cumsum(rp), np.asarray(cols), np.asarray(vals), n, lower=False,
                            device="cpu")


def _ic0_factors(cuda_device):
    from stormx_torch.precond import IcPreconditioner

    _, pcsr = _diffusion_on_card(cuda_device)
    pcsr = CSR(data=np.asarray(pcsr.data, dtype=np.float64), indices=pcsr.indices,
               row_ptr=pcsr.row_ptr, shape=pcsr.shape)
    ic = IcPreconditioner(pcsr, device="cpu")
    return {"ic0_lower": ic._first, "ic0_upper": ic._second}


def _wide_levels(width, levels, seed):
    """A lower factor of ``levels`` levels of ``width`` rows each, every row
    of a level reading 1–3 rows of the levels before it: levels wider than
    a block of 512 threads, and dependencies many levels old."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    n = width * levels
    rows, cols, vals = list(range(n)), list(range(n)), list(1.0 + rng.random(n))
    for i in range(width, n):
        lev = i // width
        deps = {int(j) for j in rng.choice(lev * width, size=int(rng.integers(1, 4)),
                                           replace=False)}
        deps.add((lev - 1) * width + int(rng.integers(width)))  # so that the row's level is lev
        for j in sorted(deps):
            rows.append(i), cols.append(j), vals.append(float(rng.standard_normal()))
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    tri = build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True, device="cpu")
    assert tri.num_levels == levels
    return tri


def _small(n, seed):
    """A random lower factor of fewer rows than a block of 512 threads."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    a = np.diag(2.0 + rng.random(n))
    for i in range(1, n):  # up to three earlier rows each
        a[i, rng.choice(i, size=min(i, int(rng.integers(0, 4))), replace=False)] = \
            rng.standard_normal()
    rows, cols = np.nonzero(a)
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return build_triangular(np.cumsum(rp), cols, a[rows, cols], n, lower=True, device="cpu")


def _narrow_levels(n, seed):
    """A lower factor in levels of 3 and 5 rows in turn, every row reading
    one or two rows of the level just before: levels that begin and end
    inside one warp's groups of T1, each row waiting on rows held by
    other groups of its own warp."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    starts = np.cumsum([0] + [3 + 2 * (i % 2) for i in range(n)])
    starts = starts[starts < n]
    rows, cols, vals = list(range(n)), list(range(n)), list(2.0 + rng.random(n))
    for lo, hi, nxt in zip(starts[:-1], starts[1:], list(starts[2:]) + [n]):
        for i in range(hi, nxt):
            for j in sorted(set(rng.integers(lo, hi, size=int(rng.integers(1, 3))).tolist())):
                rows.append(i), cols.append(j), vals.append(float(rng.standard_normal()))
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    tri = build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True, device="cpu")
    assert tri.num_levels == len(starts) and tri.level_rows.shape[1] == 5
    return tri


def _slots(K, width, levels, seed):
    """A lower factor of ``levels`` levels of ``width`` rows whose rows from
    the second level on read K rows each (fewer where fewer lie before
    them), one in the level just before: rows of exactly K slots, so that T1
    runs at the group width of K, in passes of 32 when K > 32."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    n = width * levels
    rows, cols, vals = list(range(n)), list(range(n)), list(2.0 + rng.random(n))
    for i in range(width, n):
        lev = i // width
        first = (lev - 1) * width + int(rng.integers(width))
        rest = rng.choice(lev * width, size=min(K, lev * width), replace=False).tolist()
        for j in sorted(set([first] + [c for c in rest if c != first][:K - 1])):
            rows.append(i), cols.append(j), vals.append(float(rng.standard_normal()) / K)
    rows, cols, vals = np.asarray(rows), np.asarray(cols), np.asarray(vals)
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    tri = build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True, device="cpu")
    assert tri.ell_cols.shape[1] == K and tri.num_levels == levels
    return tri


TRI_CASES = ("chain", "against_order", "ic0_lower", "ic0_upper", "wide_levels", "small",
             "narrow_levels")
TRI_DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _tri_case(name, cuda_device):
    if name == "chain":
        return _chain(100_000, 1)
    if name == "against_order":
        return _against_order(20_000, 2)
    if name == "wide_levels":
        return _wide_levels(5_000, 3, 4)
    if name == "small":
        return _small(300, 5)
    if name == "narrow_levels":
        return _narrow_levels(3_000, 6)
    return _ic0_factors(cuda_device)[name]


def _rhs(n, dtype, seed=3):
    gen = np.random.default_rng(seed)
    return torch.as_tensor(gen.standard_normal(n) + (1j * gen.standard_normal(n)
                                                     if dtype.is_complex else 0)).to(dtype)


@pytest.mark.parametrize("dtype", TRI_DTYPES, ids=str)
@pytest.mark.parametrize("case", TRI_CASES)
def test_tri_kernels_match_plain_version(cuda_device, case, dtype):
    """T1 and T2 (3 sweeps) against their plain versions: bit
    for bit in float32 and float64, within 4 ulp of max|y| in complex (the
    kernels write the complex product out in one order, torch in its own).
    The plain exact solve of the 10⁵-level chain runs on the CPU (the same
    IEEE roundings; on the card it would be 10⁶ launches)."""
    from stormx_torch.ops import tri_solve as tk
    from stormx_torch.precond import tri_solve

    tri_cpu = _tri_case(case, cuda_device).astype(dtype)
    tri = _to_card(tri_cpu, cuda_device)
    n = tri.num_rows
    r = _rhs(n, dtype)
    exact_plain = (tk.exact_plain(tri_cpu, r) if case == "chain"
                   else tk.exact_plain(tri, r.to(cuda_device)).cpu())
    before = dict(tk.launches)
    got = {None: tk.exact_cuda(tri, r.to(cuda_device)).cpu(),
           3: tri_solve(tri, r.to(cuda_device), sweeps=3).cpu()}
    torch.cuda.synchronize()
    tk.check_watchdog()
    assert tk.launches["tri_exact"] - before["tri_exact"] == 1
    assert tk.launches["tri_sweep"] - before["tri_sweep"] == 3
    want = {None: exact_plain, 3: tk.sweep_plain(tri, r.to(cuda_device), 3).cpu()}
    for sweeps in (None, 3):
        assert bool(torch.isfinite(want[sweeps]).all())
        if dtype.is_complex:
            eps = torch.finfo(torch.float32 if dtype == torch.complex64 else torch.float64).eps
            assert _close(got[sweeps], want[sweeps], 4 * eps), (case, sweeps)
        else:
            assert torch.equal(got[sweeps], want[sweeps]), (case, sweeps)


@pytest.mark.parametrize("dtype", TRI_DTYPES, ids=str)
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 8, 9, 40])
def test_tri_grid_slots(cuda_device, K, dtype):
    """T1 at the slots a lane of every K from 1 to 9 and of K = 40 (passes
    of 8), and at every slot count the kernel is built for, on 40 strands of
    40 rows (the rows of a level in 40 warps): bit for bit the plain version
    in float32 and float64 (within 4 ulp of max|y| in complex, as above);
    one launch at ``grid_slots(K)``."""
    from stormx_torch.ops import tri_solve as tk

    tri_cpu = _slots(K, 40, 40, K).astype(dtype)
    tri = _to_card(tri_cpu, cuda_device)
    r = _rhs(tri.num_rows, dtype, seed=K).to(cuda_device)
    before = dict(tk.slot_launches)
    got = tk.exact_cuda(tri, r)
    torch.cuda.synchronize()
    tk.check_watchdog()
    assert {s: tk.slot_launches[s] - before[s] for s in tk.GRID_SLOTS} == {
        s: int(s == tk.grid_slots(K)) for s in tk.GRID_SLOTS}
    want = tk.exact_plain(tri, r)
    assert bool(torch.isfinite(want).all())
    if dtype.is_complex:
        eps = torch.finfo(torch.float32 if dtype == torch.complex64 else torch.float64).eps
        assert _close(got.cpu(), want.cpu(), 4 * eps)
    else:
        assert torch.equal(got, want)
    rule = tk.grid_slots
    try:
        for S in tk.GRID_SLOTS:
            tk.grid_slots = lambda K, S=S: S
            tk._plans.clear()
            y = tk.exact_cuda(tri, r)
            torch.cuda.synchronize()
            tk.check_watchdog()
            assert torch.equal(y, got), S
    finally:
        tk.grid_slots = rule
        tk._plans.clear()


def test_tri_grid_round_robin_strands(cuda_device):
    """Where a factor's strands are more than the card holds at once, T1
    deals the level order out to as many strands as it holds, and
    gives the same bits: a factor of 2·10⁵ rows in 4 levels."""
    from stormx_torch.ops import tri_solve as tk

    tri = _to_card(_wide_levels(50_000, 4, 8), cuda_device)
    assert tri.strand_ptr.numel() - 1 == 50_000
    r = _rhs(tri.num_rows, torch.float64, seed=4).to(cuda_device)
    want = tk.exact_plain(tri, r)
    room = tk._resident_warps(_cuda_lib(), cuda_device.index or 0, 1,
                              tk.grid_slots(tri.ell_cols.shape[1]))
    got = tk.exact_cuda(tri, r)
    torch.cuda.synchronize()
    tk.check_watchdog()
    assert torch.equal(got, want)
    plan = tk._plans[id(tri)][3]
    assert (plan[1].strands == min(room, 50_000)) and (room >= 50_000 or plan[3])


def _cuda_lib():
    from stormx_torch.ops import _cuda

    return _cuda.library("tri_solve")


def test_tri_narrow_and_wide_levels_take_one_t1_launch(cuda_device):
    """Narrow levels (a chain, a small factor, the 8,400-row 2-D IC(0)
    factor: 33 rows a level) and wide ones each take one T1 launch, at the
    slots ``grid_slots`` gives their K, with the plain version's bits."""
    from stormx_torch.ops import tri_solve as tk
    from stormx_torch.precond import tri_solve

    for case in ("ic0_lower", "chain", "small", "wide_levels"):
        tri = _to_card(_tri_case(case, cuda_device).astype(torch.float32), cuda_device)
        S = tk.grid_slots(tri.ell_vals.shape[1])
        r = torch.ones(tri.num_rows, device=cuda_device)
        before, by_slots = dict(tk.launches), dict(tk.slot_launches)
        y = tri_solve(tri, r)
        tk.check_watchdog()
        assert tk.launches["tri_exact"] - before["tri_exact"] == 1, case
        assert tk.slot_launches[S] - by_slots[S] == 1, case
        if case != "chain":  # the chain's plain solve is 10⁵ launches
            assert torch.equal(y, tk.exact_plain(tri, r)), case


@pytest.mark.parametrize("kind", ["exact", "sweeps3"])
def test_tri_solve_is_one_t1_or_k_t2_launches(cuda_device, kind):
    """An exact solve is one T1 kernel (behind a memset of its flag words and
    followed by a device-to-host copy of its error words, neither a
    kernel), a 3-sweep solve three T2 kernels."""
    from stormx_torch.ops import tri_solve as tk
    from stormx_torch.precond import tri_solve

    tri = _to_card(_ic0_factors(cuda_device)["ic0_lower"].astype(torch.float32), cuda_device)
    r = torch.randn(tri.num_rows, device=cuda_device)
    if kind == "sweeps3":
        names = _cuda_kernels_in(lambda: tri_solve(tri, r, sweeps=3))
    else:
        names = _cuda_kernels_in(lambda: tk.exact_cuda(tri, r))
    tk.check_watchdog()
    kernels = [n for n in names if "memcpy" not in n.lower() and "memset" not in n.lower()]
    if kind == "exact":
        assert len(kernels) == 1 and "tri_exact_kernel" in kernels[0], names
    else:
        assert len(kernels) == 3 and all("tri_sweep_kernel" in k for k in kernels), names


def test_tri_exact_does_not_wait_and_is_reentrant(cuda_device):
    """T1's wrapper returns while the card is still busy before it (no host
    sync), and two solves of one factor in flight at once, on two streams,
    each give the plain version's bits: every solve has its own flags."""
    from stormx_torch.ops import tri_solve as tk

    tri = _to_card(_ic0_factors(cuda_device)["ic0_lower"].astype(torch.float32), cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(7)
    r1 = torch.randn(tri.num_rows, generator=gen).to(cuda_device)
    r2 = torch.randn(tri.num_rows, generator=gen).to(cuda_device)
    want1, want2 = tk.exact_plain(tri, r1), tk.exact_plain(tri, r2)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of the card
    y = tk.exact_cuda(tri, r1)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert torch.equal(y, want1)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for _ in range(3):
        with torch.cuda.stream(s1):
            y1 = tk.exact_cuda(tri, r1)
        with torch.cuda.stream(s2):
            y2 = tk.exact_cuda(tri, r2)
        torch.cuda.synchronize()
        assert torch.equal(y1, want1) and torch.equal(y2, want2)
    tk.check_watchdog()


WATCHDOG_SCRIPT = r"""
import re
import sys

import numpy as np
import torch

sys.path.insert(0, sys.argv[1])
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops import tri_solve as tk
from stormx_torch.precond import build_triangular

tk.WATCHDOG_S = 0.5
dev = torch.device("cuda")
n = 5000
rows = np.concatenate([np.arange(n), np.arange(1, n)])
cols = np.concatenate([np.arange(n), np.arange(n - 1)])
vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0)])
order = np.lexsort((cols, rows))
rp = np.zeros(n + 1, dtype=np.int64)
np.add.at(rp, rows + 1, 1)
chain = build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True, device=dev)
solve = tk.exact_cuda

# Row 3000 reads itself: T1 waits on it, so it and every row after it
# wait, and the first of them to pass the watchdog reports.  A column
# outside the rows is reported at once.
cases = ((3000, 3000, "watchdog", range(3000, n)), (10, n + 5, "outside", [10]))
field = "ell_cols"
for good in (chain, chain.astype(torch.float32)):
    r = torch.ones(n, dtype=good.ell_vals.dtype, device=dev)
    for row, col, what, reporters in cases:
        bad_cols = getattr(good, field).clone()
        bad_cols[row, 0] = col
        bad = good._replace(**{field: bad_cols})
        # Raised by check_watchdog, which waits, and by the next T1 call once
        # the failed solve has ended; the rows it could not solve are NaN.
        for raise_at in ("check_watchdog", "next call"):
            y = solve(bad, r)
            try:
                if raise_at == "check_watchdog":
                    tk.check_watchdog()
                else:
                    torch.cuda.synchronize()
                    solve(good, r)
            except StormError as err:
                at = int(re.search(r"at row (\d+)", str(err)).group(1))
                assert what in str(err) and at in reporters, err
            else:
                raise AssertionError(f"no StormError for column {col} in row {row} "
                                     f"at {raise_at}")
            assert bool(torch.isnan(y[row]).item()), (row, y[row])
        # Nothing of a failed solve is left to the next one.
        assert torch.equal(solve(good, r).cpu(), tk.exact_plain(good, r).cpu())
        tk.check_watchdog()
print("ok")
"""


def test_tri_exact_watchdog_raises(cuda_device):
    """A row that reads itself (a dependency that never becomes ready) and a
    column outside the rows each raise StormError instead of hanging the
    card (at ``check_watchdog`` and at the next T1 call), leave NaN in the
    row, and leave nothing to the next solve, in float32 and float64.  In a
    subprocess with a time limit, so that a hang fails the test."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", WATCHDOG_SCRIPT, repo], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


# -- CG's loop as replays of a captured CUDA graph (solvers/base.py) ----------


def _raw_bits(t):
    t = t.contiguous()
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _poisson5_dia(m, dtype, device):
    """The five-point Laplacian of an m×m grid (Dirichlet), as DIA."""
    n = m * m
    data = np.zeros((5, n))
    data[2] = 4.0
    col = np.arange(n) % m
    data[1, 1:] = np.where(col[1:] != 0, -1.0, 0.0)  # offset −1: row i reads i − 1
    data[3, :-1] = np.where(col[:-1] != m - 1, -1.0, 0.0)  # offset +1
    data[0, m:] = -1.0
    data[4, :-m] = -1.0
    return DIA(data=torch.as_tensor(data, dtype=dtype, device=device),
               offsets=(-m, -1, 0, 1, m), shape=(n, n))


def _graph_case(case, device):
    """(operator, b, options) of a solve the graph path takes: plain CG on
    the Cahn–Hilliard operator through K1 "staged" in float32, or on a
    float64 five-point Poisson DIA through K2a."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.solvers import SolverOptions

    rng = np.random.default_rng(11)
    if case == "ch_staged_float32":
        mesh = structured_tri_rect(60, 50).optimize_ordering()
        op = make_assembled_step(mesh, dtype=torch.float32, device=device).operator
        b = torch.as_tensor(rng.standard_normal(op.shape[0]), dtype=torch.float32, device=device)
        return (lambda v: sell_spmv.sell_spmv_cuda(op, v, branch="staged"), b,
                SolverOptions(num_iterations=2000, absolute_tolerance=0.0,
                              relative_tolerance=1e-6))
    a = _poisson5_dia(256, torch.float64, device)
    b = torch.as_tensor(rng.standard_normal(a.shape[0]), dtype=torch.float64, device=device)
    return a.matvec, b, SolverOptions(num_iterations=5000, absolute_tolerance=1e-9,
                                      relative_tolerance=1e-10)


def _solve_cg(apply, b, opts, monkeypatch, *, eager=False, precond=None):
    """CG on the card, through the graph path or (``eager``) the eager loop."""
    from stormx_torch.solvers import base, cg, make_operator

    with monkeypatch.context() as m:
        if eager:
            m.setattr(base, "_engages", lambda x0: False)
        res = cg(make_operator(apply), b, torch.zeros_like(b), precond=precond, options=opts)
    torch.cuda.synchronize()
    return res


def _assert_bit_identical(got, want):
    assert got.num_iterations == want.num_iterations and got.converged == want.converged
    for name in ("x", "history", "absolute_error", "relative_error"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(_raw_bits(g.cpu()), _raw_bits(w.cpu())), name


GRAPH_CASES = ["ch_staged_float32", "poisson_dia_float64"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_cg_graph_replays_equal_the_eager_loop(cuda_device, monkeypatch, case):
    """CG run as graph replays gives the eager loop's x, history, iterations,
    converged and errors bit for bit, with one capture and no fallback."""
    from stormx_torch.solvers import base

    apply, b, opts = _graph_case(case, cuda_device)
    eager = _solve_cg(apply, b, opts, monkeypatch, eager=True)
    before = dict(base.graph_stats)
    graphed = _solve_cg(apply, b, opts, monkeypatch)
    stats = {k: base.graph_stats[k] - before[k] for k in before}
    assert stats["captures"] == 1 and stats["replays"] >= 2 and stats["fallbacks"] == 0, stats
    assert stats["masked"] < base.BLOCK_ITERATIONS, stats
    assert eager.converged and 0 < eager.num_iterations < opts.num_iterations
    _assert_bit_identical(graphed, eager)


def _kernels_traced(fn, patterns, attempts=3):
    """For each attempt, (the kernels matching each pattern in the profiler's
    raw records of a traced call of ``fn``, as the benchmark reduces them, by
    the runtime call that launched them, fn's result).  A session now and
    then loses records, its first ones most often (``_cuda_kernels_in``), so
    each opens with empty kernels and is taken again."""
    import re

    from torch.profiler import ProfilerActivity, profile

    dt = torch.autograd.DeviceType
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                banded_gather.empty_launch(1, torch.device("cuda"))
            out = fn()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        calls = {e.correlation_id(): e.name() for e in events
                 if e.device_type() == dt.CPU and e.name().startswith("cuda")}
        seen = {}
        for e in events:
            if e.device_type() != dt.CUDA or e.is_user_annotation():
                continue
            for k, p in patterns.items():
                if re.search(p, e.name()):
                    by = seen.setdefault(k, {})
                    call = calls.get(e.correlation_id(), "?")
                    by[call] = by.get(call, 0) + 1
        yield seen, out


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_cg_graph_launch_counters_count_the_replayed_kernels(cuda_device, monkeypatch, case):
    """Under replay the wrappers do not run: the capture takes back what it
    counted and each replay adds it again, so ``sell_spmv.launches`` and
    ``dia.launches`` equal the kernels the card ran (one a residual and one
    an iteration, frozen ones too), and the replays' share equals the
    kernels a profiler trace records as launched by ``cudaGraphLaunch``.
    (The residual's own eager record is left out: in a run of this whole
    file the profiler drops it, while the benchmark's traced windows keep
    every record.)"""
    from stormx_torch.solvers import base

    apply, b, opts = _graph_case(case, cuda_device)
    _solve_cg(apply, b, opts, monkeypatch)  # a first profiler session loses records

    def counters():
        return {"k1": sell_spmv.launches, "k2a": dia.launches["dia_spmv"]}

    traced = []
    for _ in range(3):
        c0, s0 = counters(), dict(base.graph_stats)
        for seen, res in _kernels_traced(lambda: _solve_cg(apply, b, opts, monkeypatch),
                                         {"k1": r"sell_spmv(_staged)?_kernel",
                                          "k2a": r"dia_spmv_kernel"}, attempts=1):
            counted = {k: v - c0[k] for k, v in counters().items()}
            stats = {k: base.graph_stats[k] - s0[k] for k in s0}
            ran = res.num_iterations + stats["masked"]
            in_graphs = stats["replays"] * base.BLOCK_ITERATIONS
            which = "k1" if case.startswith("ch") else "k2a"
            assert counted[which] == ran + 1 and sum(counted.values()) == ran + 1, counted
            assert in_graphs == stats["iterations"] + stats["masked"] > 0, stats
            traced.append((seen, counted))
            replayed = {k: seen.get(k, {}).get("cudaGraphLaunch", 0) for k in counted}
            if replayed[which] == in_graphs and sum(replayed.values()) == in_graphs:
                return
    raise AssertionError(f"no trace held the counted kernels: {traced}")


def test_cg_graph_result_outlives_the_next_solve(cuda_device, monkeypatch):
    """The returned tensors are made outside the capture: a second solve,
    with its own graph, leaves the first solve's x and history as they were."""
    apply, b, opts = _graph_case("ch_staged_float32", cuda_device)
    first = _solve_cg(apply, b, opts, monkeypatch)
    kept = (first.x.clone(), first.history.clone(), first.absolute_error.clone())
    _solve_cg(apply, torch.flip(b, (0,)) * 3.0, opts, monkeypatch)
    for got, want in zip((first.x, first.history, first.absolute_error), kept):
        assert torch.equal(_raw_bits(got), _raw_bits(want))


def test_ic0_cg_falls_back_to_the_eager_loop(cuda_device, monkeypatch):
    """IC(0)'s T1 counts a refusal at each eager call: the solve sees it in
    its eager start and goes on eagerly (one fallback, no capture or
    replay), equals an eager solve bit for bit, takes as many T1 slots and
    counts as many launches as it, and leaves no solve unread; the next
    solve with that preconditioner does the same (nothing is remembered)."""
    from stormx_torch.ops import tri_solve
    from stormx_torch.precond import IcPreconditioner
    from stormx_torch.solvers import SolverOptions, base

    op, pcsr = _diffusion_on_card(cuda_device)
    ic = IcPreconditioner(pcsr, device=cuda_device)
    b = torch.as_tensor(np.random.default_rng(12).standard_normal(op.shape[0]),
                        dtype=torch.float32, device=cuda_device)
    opts = SolverOptions(num_iterations=500, absolute_tolerance=0.0, relative_tolerance=1e-6)
    take_slot = tri_solve._take_slot
    runs = {}
    for name in ("eager", "fallback", "again"):
        taken = []
        monkeypatch.setattr(tri_solve, "_take_slot",
                            lambda lib, index: taken.append(1) or take_slot(lib, index))
        c0 = (sell_spmv.launches, tri_solve.launches["tri_exact"], dict(base.graph_stats))
        res = _solve_cg(op.matvec, b, opts, monkeypatch, eager=name == "eager", precond=ic)
        tri_solve.check_watchdog()
        runs[name] = (res, len(taken), sell_spmv.launches - c0[0],
                      tri_solve.launches["tri_exact"] - c0[1],
                      {k: base.graph_stats[k] - c0[2][k] for k in c0[2]})
        assert not tri_solve._pending
    (eager, *e_counts, e_stats), (fallback, *f_counts, f_stats) = runs["eager"], runs["fallback"]
    again, *a_counts, a_stats = runs["again"]
    assert eager.num_iterations > 2 * base.BLOCK_ITERATIONS
    assert e_stats == dict.fromkeys(e_stats, 0), e_stats
    assert f_stats == a_stats == {**dict.fromkeys(f_stats, 0), "fallbacks": 1}, (f_stats, a_stats)
    _assert_bit_identical(fallback, eager)
    _assert_bit_identical(again, eager)
    assert f_counts == e_counts == a_counts == [2 * (eager.num_iterations + 1),
                                                eager.num_iterations + 1,
                                                2 * (eager.num_iterations + 1)], (e_counts, f_counts)


def _private_pool_segments():
    """The allocator's segments that belong to a graph's memory pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(1 for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


@pytest.mark.parametrize("reader", ["operator_reads_device", "nan_checks"])
def test_cg_that_reads_the_device_runs_eagerly(cuda_device, monkeypatch, reader):
    """An operator that reads the device (a host ``float`` of a norm, legal
    eagerly, forbidden in a capture) fails its capture: the capture is ended
    and discarded, its memory pool freed, and the solve goes on eagerly from
    the same state, equal to an eager solve bit for bit.  Under
    ``enable_nan_checks`` (a read after each op) the check mode refuses at
    its eager calls and no capture is tried.  A graph solve afterwards
    captures, replays and equals its eager solve."""
    from stormx_torch.core import enable_nan_checks
    from stormx_torch.solvers import SolverOptions, base

    a = _poisson5_dia(64, torch.float64, cuda_device)
    b = torch.as_tensor(np.random.default_rng(13).standard_normal(a.shape[0]),
                        dtype=torch.float64, device=cuda_device)
    opts = SolverOptions(num_iterations=2000, absolute_tolerance=0.0, relative_tolerance=1e-9)

    def reads(v):
        scale = 1.0 if float(v.abs().max()) >= 0.0 else 0.0  # a read of the device
        return a.matvec(v) * scale

    apply = reads if reader == "operator_reads_device" else a.matvec
    pools = _private_pool_segments()
    if reader == "nan_checks":
        enable_nan_checks()
    try:
        eager = _solve_cg(apply, b, opts, monkeypatch, eager=True)
        before = dict(base.graph_stats)
        fell_back = _solve_cg(apply, b, opts, monkeypatch)
    finally:
        enable_nan_checks(False)
    stats = {k: base.graph_stats[k] - before[k] for k in before}
    assert stats == {**dict.fromkeys(stats, 0), "fallbacks": 1}, stats
    assert eager.converged and eager.num_iterations > 2 * base.BLOCK_ITERATIONS
    _assert_bit_identical(fell_back, eager)
    assert _private_pool_segments() == pools

    plain = _solve_cg(a.matvec, b, opts, monkeypatch, eager=True)
    before = dict(base.graph_stats)
    graphed = _solve_cg(a.matvec, b, opts, monkeypatch)
    stats = {k: base.graph_stats[k] - before[k] for k in before}
    assert stats["captures"] == 1 and stats["replays"] >= 1 and stats["fallbacks"] == 0, stats
    _assert_bit_identical(graphed, plain)
