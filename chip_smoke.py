#!/usr/bin/env python3
"""Drive the stormx_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card (it exits
non-zero without one, or without the ``stormx_torch`` package beside it).
Phases, each printed as one JSON line:

1. ``device``: the card, ``nvidia-smi``'s name and power limit, and the
   build of every CUDA kernel of ``stormx_torch/csrc`` (one ``nvcc`` each,
   all started together).
2. ``mesh``: a Delaunay triangulation of 160,000 points of the unit
   square (a 400×400 grid, interior points jittered uniformly by up to
   0.35 spacing, seed 0; 318,402 cells), written as TetGen
   ``.node``/``.ele`` files, read back with ``read_tetgen`` and reordered
   by ``optimize_ordering``.  Plain uniform random points would leave
   sliver triangles along the hull (smallest cell ~1e-3 of the median),
   and the τγ·D² term of the Cahn–Hilliard operator scales like 1/area²,
   so CG on it does not converge even in float64
   (``scripts/torch_f32_study.py mesh``); the jittered grid keeps the
   smallest cell at ~0.09 of the median, like the quality-constrained
   Triangle meshes the reference app reads.
3. ``kernel_check``: each kernel against its plain PyTorch version at the
   main path's shapes — K1 on the Cahn–Hilliard operator (within
   1e-5·max|y|), K3 on the four mesh gather plans (bit-exact, and one CUDA
   kernel in a ``torch.profiler`` trace of one call; once more with a
   complex128 field on one plan) — with CUDA event
   timings (median of 30 after warm-up) beside one library call; then
   ``launch_cost``: an empty kernel's time, the card's fixed cost per
   launch, beside K3's times and bounds.
4. ``app``: three assembled Cahn–Hilliard steps in float32 on the card
   (through ``make_assembled_step`` and again through ``run``), step 1 held
   against the port on the CPU in float64 (within ``CH_GAP``, CG
   iterations within 10%), plus one matrix-free step.
5. ``poisson``: Milestone A — CG + Jacobi on the two-point-flux Laplacian
   of the same mesh, float32, to a relative tolerance of ``POISSON_RTOL``,
   and the same solve on the CPU in float64 to 1e-8.
6. ``profile``: a ``torch.profiler`` trace of 200 iterations of that CG:
   the device-busy share and the kernel time by name.

The banded (DIA) path follows, on the 5-point Dirichlet Poisson operator of
``bench.py`` on a 2048×2048 grid (4,194,304 rows, float32 on the card, the
right-hand side from ``default_rng(0)``):

7. ``banded_kernel_check``: K2a (``dia_spmv``), K2a with its dot product
   (``dia_spmv_dots``) and K2b (``cg_fused_update``) against their plain
   versions on that operator, timed warm and with L2 flushed beside their
   plain versions, the bound and, for K2a, ``torch.sparse_csr_tensor @ x``;
   then K2a on the FVM route, ``assemble_divgrad_dia`` of a 512×512
   structured triangle mesh, against the ELL matvec of ``assemble_divgrad``.
8. ``banded_cg``: unpreconditioned CG to a relative tolerance of 1e-5
   through ``solve(dia, b, method="cg")`` (K2a via ``DIA.matvec``) and
   through a loop of ``cg_step`` (K2a with its dot product, and K2b) that
   reads the device only every ``CHECK_EVERY`` iterations; iteration counts
   within 2% of each other, each true residual (float64, on the card)
   under its gate, and a 200-iteration ``torch.profiler`` trace of each.
9. ``banded_amg``: CG + ``BlockDiaAmg(group=4, num_sweeps=1)`` through
   ``solve`` to the same tolerance.
10. ``krylov``: every other ported method through ``solve`` with the same
    preconditioner, LGMRES and LFGMRES among them, to the same tolerance with
    a cap of 2,000 iterations.

The packed path (K4) follows, on the operators of phases 3 and 5 repacked at
R = 512 rows per block (``sell_from_csr(..., reorder=False)`` on their
ordered CSR, then ``pack_sell``):

11. ``packed_kernel_check``: K4a (``"matmul"``) and K4b (``"gather"``) against
    their plain versions and against K1 on the CH operator and the Laplacian
    (within 1e-5·max|y|; the Laplacian also at R = 128, K4a's ``sub == 1``
    branch), timed warm and L2-flushed beside K1, ``torch.sparse_csr_tensor @
    x``, the host packing seconds and the bound (K4a also with ``rows_used``
    and the bytes it reads; K4b with the bytes it reads, the sectors per
    request of its per-row kernel, its branch, blocks per SM and waves, and
    that per-row kernel's time in the same run); K4b's two branches keep
    the plain version's non-finite rows with Inf in x, and its per-row
    branch runs on a synthetic operator whose M exceeds a block's shared
    memory (``K4B_OVER_BUDGET``); P1 (``lane_gather``)
    bit-exact against ``torch.gather`` at 16 and at nb·M rows of 128; P2
    (``dia_stream_probe``) in its four modes at 4,194,304 rows beside K2a.
12. ``packed_poisson``: Milestone A as phase 5 runs it, through
    ``solve(make_operator(packed.matvec), ...)`` once per variant: converged,
    iterations within 2% of phase 5's, the same true-residual gate, and the
    variant's kernel launched where K1 was not; then 200 iterations of each
    profiled as phase 5's, K4a's also without the ``autograd.Function``.
13. ``nonlinear``: F(u) = 0.01·L·u + atan(u) = b on the Laplacian through
    K4a, float32, with b = F(x_true) computed in float64 on the CPU through
    the CSR Laplacian: damped Newton (Armijo; the default Jacobian is
    ``torch.func.jvp`` through K4a's ``autograd.Function``) from u = 20 and
    JFNK (Eisenstat–Walker) from u = 0, gated on their residual and their
    gap to the same runs in float64 on the CPU with the CSR Laplacian, which
    must converge; the undamped Newton and JFNK from 20, recorded.

The launch counters are set to 0 just before each of phases 4, 5, 8–10 and
11–13 and read just after; K1 and K3 must have run in the app phase, K1 in
the Poisson phase, K2a in phases 8–10, K2a with its dot product and K2b in
phase 8, P1 and P2 in phase 11 and K4a and K4b in phases 12–13.  Then come
the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GRID_SIDE = 400  # 160,000 mesh points
JITTER = 0.35  # of the grid spacing, interior points only
# CG of the Cahn–Hilliard steps.  The relative rule measures a warm-started
# step against its own small initial residual: on this mesh steps 2 and 3
# then need well over 10,000 iterations even in float64
# (``scripts/torch_f32_study.py ch`` on an H100).  Step 1's relative rule
# stops at ‖r‖ ≈ 56, so an absolute tolerance of 10 (an RMS residual of
# 0.018 per cell) asks no less of steps 2 and 3 than step 1 gets.
CH_OPTIONS = dict(num_iterations=10_000, absolute_tolerance=10.0, relative_tolerance=1e-6)
# Step 1 on the card in float32 against the CPU in float64.  A is very
# stiff here (τγ·D² ~ 1/h⁴), and rounding A and c to float32 alone moves the
# solution by ~5e-4: the gap does not shrink at rtol 1e-8, where both runs
# converge to ‖r‖ ≈ 0.56, and it is ~1.2e-4 even at 159k cells
# (``scripts/torch_f32_study.py ch`` on an H100).
CH_GAP = 1e-3
# Milestone A in float32.  Rounding the pure-Neumann Laplacian to float32
# breaks its exact zero row sums; float32 CG + Jacobi then bottoms out at a
# relative residual of ~6e-5 and diverges along the constant nullspace,
# while float64 reaches 1e-6 (``scripts/torch_f32_study.py poisson`` on an
# H100).
# 1e-4 is the tightest decade float32 reaches.  The true residual of the
# float32 solution, measured 3.1e-2·‖b‖ (float32 rounding of L and of the
# SpMVs, ~eps·cond(L) at this size), is gated at 5e-2·‖b‖ rather than the
# 1e-2 of the JAX package's float32 dry run on 3,200 cells; the same solve on
# the CPU in float64 is held to rtol 1e-8 and a true residual of 1.1e-8.
POISSON_RTOL = 1e-4
POISSON_TRUE_RES = 5e-2
# The kernels of the main path; the cell-adjacency plan serves gradients and
# limiters, which the Cahn–Hilliard app does not run, so it is checked only.
ON_PATH = ("sell_spmv", "banded_gather/face_inner", "banded_gather/face_outer",
           "banded_gather/cell_face")
H100_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_F32_FLOPS = 67e12
TIMING_REPS = 30
SLEEP_CYCLES = 4_000_000  # ~2 ms at the H100's boost clock
PROFILE_ITERATIONS = 200
CH_STEPS = 3

# The banded path.  NX is bench.py's headline grid.
NX = 2048
FVM_SIDE = 512  # 524,288 cells; the host build takes ~6 s
BANDED_RTOL = 1e-5
CG_MAX_ITERATIONS = 20_000
KRYLOV_MAX_ITERATIONS = 2_000
CHECK_EVERY = 100  # iterations of the cg_step loop between host reads
AMG_OPTIONS = dict(group=4, num_sweeps=1)
KRYLOV_METHODS = ("richardson", "cgs", "bicgstab", "bicgstab_l", "tfqmr", "tfqmr1", "idrs",
                  "gmres", "fgmres", "lgmres", "lfgmres")
# Richardson's default ω = 1e-4 (the reference's) would need ~1e5 iterations;
# with ω = 1 it is the stationary V-cycle iteration.
KRYLOV_KWARGS = {"richardson": dict(relaxation_factor=1.0)}
# Gates on the true relative residual ‖b − A·x‖/‖b‖ of each float32 solve,
# computed in float64 on the card.  Measured on an H100 80GB HBM3 at 700 W:
# CG 9.7e-4 through solve and through cg_step (the recurrence residual keeps
# falling to 1e-5 after the true residual floors at ~eps·cond(A)), CG + AMG
# 4.2e-4, TFQMR 3.8e-4, TFQMR1 3.5e-4, GMRES and FGMRES 2.2e-5.
BANDED_CG_TRUE_RES = 2e-3
BANDED_AMG_TRUE_RES = 1e-3
KRYLOV_TRUE_RES = {"tfqmr": 1e-3, "tfqmr1": 1e-3, "gmres": 1e-4, "fgmres": 1e-4,
                   "lgmres": 1e-4, "lfgmres": 1e-4}
# Methods that break down in float32 at this size: their residual falls to a
# best value and then grows without bound (BiCGStab to NaN), with either
# preconditioner side.  Rerun in float64 on the same operator, each converges
# (CGS in 291 iterations, BiCGStab 348, BiCGStab(l) 401, IDR(s) 509).  Each is
# gated on the best relative residual its float32 run reaches (measured 2.0e-4,
# 5.6e-5, 1.3e-5 and 1.5e-3, at iterations 405, 449, 1,446 and 490) and on
# converging in float64.  The JAX package breaks down the same way in float32
# (tests/test_torch_f32_breakdown.py).  Their float32 runs stop about half as
# many iterations again after the best one; BiCGStab(l) keeps the common cap.
KRYLOV_F32_BEST = {"cgs": 5e-4, "bicgstab": 1.5e-4, "bicgstab_l": 5e-5, "idrs": 4e-3}
KRYLOV_F32_CAP = {"cgs": 600, "bicgstab": 700, "idrs": 750}
# Richardson with the V-cycle as its step converges too slowly at 7 levels, in
# either precision: its relative residual is 8.5e-3 after 2,000 iterations in
# float32 and 3.5e-3 after 8,000 in float64.  It is gated on reaching 2e-2
# in 2,000 iterations in both precisions.
RICHARDSON_REACH = 2e-2

# The packed path (K4, P1, P2).  R = 512 is the JAX package's block height for
# its Pallas SpMV (stormx/sparse/windowed.py:334-338) and runs K4a's owner
# sums (sub = 4); R = 128 runs its sub == 1 branch and is checked only.
PACKED_BLOCK_ROWS = 512
PACKED_CHECK_BLOCK_ROWS = 128
P1_PROBE_ROWS = 16  # scripts/pallas_gather_probe.py's shape
P2_ROWS = NX * NX  # the probe's 32 tiles × 1024 × 128: the banded operator's length
P2_C = 0.3125
PACKED_ITERATION_GAP = 0.02  # packed CG against phase 5's K1 CG
# K4b's per-row branch: a banded operator of n rows with K entries each
# (every seventh row K/2) within ``band`` of the diagonal, packed at R = 2048:
# M ≥ sub·K = 512 tile rows, whose products (266 KB) exceed a block's shared
# memory (227 KB on an H100).
K4B_OVER_BUDGET = dict(n=5_000, K=32, band=300, R=2048)
# The nonlinear problem of tests/test_solvers.py:279-305 at full width:
# F(u) = 0.01·L·u + atan(u) = F(x_true), x_true = 0.2·N(0, 1) from seed 0.
# Damped Newton (Armijo) starts at x0 = 20, deep in atan's saturation.  JFNK
# has no line search: from x0 = 20 its full steps diverge, in float64 as in
# float32 (as the undamped Newton does), so its gated run starts at x0 = 0,
# where the JAX package's JFNK tests start; its run from 20 is recorded with
# the undamped Newton and not gated.
NONLINEAR_X0 = 20.0
NONLINEAR_MAX_ITERATIONS = 100
NONLINEAR_DIVERGING_ITERATIONS = 4
NONLINEAR_RTOL = {"float32": 1e-5, "float64": 1e-8}
# Newton's inner solve, in both precisions: BiCGStab to a relative 1e-1 (a
# constant forcing term), at most 50 iterations.  The reference's 1e-8 is
# below float32's reach, and a tight inner solve does not pay here: on an
# H100 the damped Newton took 89 iterations and 77 s with 1e-4 (about 530 K4a
# launches each), 8 iterations and 0.28 s with 1e-1.  JFNK takes
# Eisenstat–Walker forcing instead.
NEWTON_INNER = dict(num_iterations=50, absolute_tolerance=0.0, relative_tolerance=1e-1,
                    record_history=False)
# Gates on the float32 runs, both computed in float64 on the CPU through the
# CSR Laplacian (no K4a): the relative residual ‖F(x) − b‖/‖F(x0) − b‖ and
# max|x − x64|, x64 the float64 run's solution.  The solver stops at 1e-5 on
# its own float32 residual; recomputing it in float64 adds the float32
# rounding of x, F and b, ~1e-7 relative here.  From u = 20, ‖r0‖ ≈ 800, so
# at the tolerance ‖r‖ ≤ ~8e-3; J's smallest eigenvalue near x_true is
# 1/(1 + max x²) ≈ 0.94, so the gap may reach ~9e-3 at that tolerance in
# any precision.  Measured on an H100 (max|x − x_true|, b through K4a):
# 3.6e-4 (Newton), 3.7e-4 (JFNK).
NONLINEAR_F32_RES = 1.1e-5
NONLINEAR_F32_GAP = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(torch, fn, *, flush=None, reps: int = TIMING_REPS, warmup: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, device time only: a sleep
    kernel queued first keeps the card busy while the host enqueues the
    events and ``fn``'s launches.  ``flush``, a tensor larger than L2, is
    overwritten before every timed call when given."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_kernels_in(torch, fn, dev, attempts: int = 3) -> tuple[list, int]:
    """The names of the CUDA kernels that one call of ``fn`` launches, from
    a ``torch.profiler`` trace (after one call outside it), and the number
    of traces that took.

    An empty kernel launched just before and just after ``fn`` brackets the
    call, and only the kernels between the two count.  A profiler session on
    the H100 has come back holding no kernel of a call that launched one: a
    trace that does not hold both brackets has lost records, and is taken
    again, ``attempts`` times at most."""
    from torch.profiler import ProfilerActivity, profile

    from stormx_torch.ops import banded_gather

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            banded_gather.empty_launch(1, dev)
            fn()
            banded_gather.empty_launch(1, dev)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        marks = [i for i, n in enumerate(names) if "empty_kernel" in n]
        if len(marks) == 2 and marks == [0, len(names) - 1]:
            return names[1:-1], attempt
    require(False, f"{attempts} profiler traces of one call lacked the empty kernels "
                   f"around it (last: {names})")


def k4a_read_bytes(torch, packed) -> dict:
    """What K4a reads, counted by 32-byte sector: the values of every tile
    row below ``rows_used``, the index words of the sectors (8 lanes) among
    them that hold a non-zero value, and x and y once."""
    nb, M, lanes = packed.vals.shape
    used = packed.rows_used.long()
    below = torch.arange(M, device=used.device)[None, :] < used[:, None]
    sectors = (packed.vals != 0).reshape(nb, M, lanes // 8, 8).any(dim=3) & below[:, :, None]
    values = 4.0 * lanes * float(used.sum())
    index = 32.0 * float(sectors.sum())
    xy = 4.0 * (packed.shape[0] + packed.shape[1])
    return dict(rows_used_mean=float(used.double().mean()), rows_used_max=int(used.max()), M=M,
                values=values, index=index, x_and_y=xy, total=values + index + xy,
                total_ms=(values + index + xy) / H100_BYTES_PER_S * 1e3)


def k4b_read_bytes(torch, packed) -> dict:
    """What K4b's staged branch reads, counted by 32-byte sector: in the tile
    rows below ``min(rows_used, M − 1)``, the values of the sectors (8 lanes)
    and the ``xlane`` bytes of the sectors (32 lanes) that hold a non-zero
    value, and tile row M − 1 whole; ``live4`` and ``xchunk`` of those rows,
    ``rows_used``, the ``src`` words of every row (sub·K tile rows a block),
    and x and y once.  Beside it, what the per-row kernel reads: the
    distinct sectors of the values and words that ``src`` names in each
    block, and the mean number of distinct sectors one warp request for a
    value (or a word) touches."""
    nb, M, lanes = packed.vals.shape
    n_rows, n_cols = packed.shape
    K, sub = packed.ell_k, packed.sub
    staged = packed.rows_used.long().clamp(max=M - 1)
    below = (torch.arange(M, device=staged.device)[None, :] < staged[:, None])[:, :, None]
    live = packed.vals != 0
    value_sectors = (live.reshape(nb, M, lanes // 8, 8).any(dim=3) & below).sum()
    lane_sectors = (live.reshape(nb, M, lanes // 32, 32).any(dim=3) & below).sum()
    values = 32.0 * float(value_sectors) + 4.0 * lanes * nb  # + tile row M − 1
    xlane = 32.0 * float(lane_sectors) + 1.0 * lanes * nb
    src = 4.0 * K * n_rows
    small = 8.0 * float(staged.sum()) + 8.0 * nb
    xy = 4.0 * (n_rows + n_cols)
    total = values + xlane + src + small + xy
    # The per-row kernel: request (b, s, k, warp) reads lanes l of tile rows
    # src[b, s·K + k, l]; a sector is (tile row, l // 8).
    named = packed.src[:, : sub * K].long() * (lanes // 8) \
        + torch.arange(lanes, device=staged.device) // 8
    per_request = named.reshape(nb, sub * K, lanes // 32, 32).sort(dim=3).values
    distinct = 1 + (per_request.diff(dim=3) != 0).sum(dim=3)
    block = torch.arange(nb, device=staged.device)[:, None, None] * (M * lanes // 8)
    block_sectors = int(torch.unique(named + block).numel())
    old_total = 2 * 32.0 * block_sectors + src + xy
    return dict(M=M, K=K, values=values, xlane=xlane, src=src,
                live4_xchunk_rows_used=small, x_and_y=xy, total=total,
                total_ms=total / H100_BYTES_PER_S * 1e3,
                rows_kernel=dict(sectors_per_request=float(distinct.double().mean()),
                                 named_values=32.0 * block_sectors,
                                 named_index=32.0 * block_sectors, total=old_total,
                                 total_ms=old_total / H100_BYTES_PER_S * 1e3))


def random_banded_csr(n: int, K: int, band: int, seed: int):
    """A float32 host CSR whose rows hold K entries within ``band`` of the
    diagonal, every seventh row K // 2 (dead entries of K4b)."""
    from stormx_torch.sparse.formats import CSR

    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n):
        near = np.arange(max(0, i - band), min(n, i + band + 1))
        cols.append(np.sort(rng.choice(near, K if i % 7 else K // 2, replace=False)))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    return CSR(data=rng.standard_normal(row_ptr[-1]).astype(np.float32),
               indices=np.concatenate(cols).astype(np.int32),
               row_ptr=row_ptr.astype(np.int32), shape=(n, n))


def nonfinite_rows(torch, y):
    return torch.nonzero(~torch.isfinite(y)).reshape(-1).cpu()


def profile_cg(torch, solve) -> dict:
    """Device-busy share and kernel time by name over ``PROFILE_ITERATIONS``
    CG iterations, from a ``torch.profiler`` trace of ``solve``."""
    from torch.profiler import ProfilerActivity, profile

    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name[:80], [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        iterations=PROFILE_ITERATIONS,
        wall_us_per_iteration=wall_us / PROFILE_ITERATIONS,
        device_busy_us_per_iteration=busy_us / PROFILE_ITERATIONS,
        device_busy_share=busy_us / wall_us if busy_us else None,
        kernels_per_iteration=sum(v[0] for v in by_name.values()) / PROFILE_ITERATIONS,
        top=[dict(name=n, count=c, us=t) for n, (c, t) in top],
    )


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def write_tetgen(prefix: str, points: np.ndarray, tris: np.ndarray) -> None:
    ids = np.arange(len(points))
    np.savetxt(prefix + "node", np.column_stack([ids, points]),
               fmt=["%d", "%.17g", "%.17g"], header=f"{len(points)} 2 0 0", comments="")
    np.savetxt(prefix + "ele", np.column_stack([np.arange(len(tris)), tris]),
               fmt="%d", header=f"{len(tris)} 3 0", comments="")


def delaunay_mesh(side: int, jitter: float, seed: int):
    """Delaunay triangles (CCW) of a ``side``×``side`` grid of the unit square
    whose interior points are moved uniformly by up to ``jitter`` spacings."""
    from scipy.spatial import Delaunay

    g = np.linspace(0.0, 1.0, side)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    interior = ((pts > 0.0) & (pts < 1.0)).all(axis=1)
    rng = np.random.default_rng(seed)
    pts[interior] += (rng.random((int(interior.sum()), 2)) - 0.5) * (2 * jitter / (side - 1))
    tris = Delaunay(pts).simplices.astype(np.int64)
    a, b, c = (pts[tris[:, i]] for i in range(3))
    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    tris[area2 < 0] = tris[area2 < 0][:, ::-1]
    return pts, tris


def sell_to_csr(op):
    """The live entries of a SlicedELL as a host CSR, in the operator's own
    (already ordered) numbering."""
    from stormx_torch.sparse.formats import CSR

    data = op.data.cpu().numpy()
    cols = op.local_cols.cpu().numpy().astype(np.int64)
    nb, _, R = data.shape
    b = np.arange(nb)[:, None, None]
    rows = np.broadcast_to(b * R + np.arange(R)[None, None, :], data.shape)
    live = data != 0
    r, c, v = rows[live], (b * R - op.pad_lo + cols)[live], data[live]
    order = np.lexsort((c, r))
    rs, cs = r[order], c[order]
    # No (row, col) pair twice, so the CSR is the matrix a coalescing build
    # (duplicates summed) would give.
    require(not np.any((rs[1:] == rs[:-1]) & (cs[1:] == cs[:-1])),
            "the SlicedELL holds a (row, col) pair twice")
    row_ptr = np.zeros(op.shape[0] + 1, dtype=np.int64)
    np.add.at(row_ptr, r + 1, 1)
    return CSR(data=v[order], indices=cs.astype(np.int32),
               row_ptr=np.cumsum(row_ptr).astype(np.int32), shape=tuple(op.shape))


def torch_csr(torch, csr, dev):
    """A host CSR as a torch CSR tensor on ``dev`` (the library yardstick)."""
    return torch.sparse_csr_tensor(torch.as_tensor(csr.row_ptr, dtype=torch.int64),
                                   torch.as_tensor(csr.indices, dtype=torch.int64),
                                   torch.as_tensor(csr.data), size=csr.shape).to(dev)


def poisson5_diags(nx: int, dtype=np.float32):
    """5-point Laplacian on an nx×nx grid in DIA layout, a copy of
    ``bench.py:poisson5_diags``.  Returns (offsets, data) with
    data[d, i] = A[i, i + offsets[d]]."""
    n = nx * nx
    i = np.arange(n) // nx
    j = np.arange(n) % nx
    offsets = (-nx, -1, 0, 1, nx)
    data = np.zeros((5, n), dtype=dtype)
    data[0] = np.where(i > 0, -1.0, 0.0)  # west  neighbor (i-1, j)
    data[1] = np.where(j > 0, -1.0, 0.0)  # south neighbor (i, j-1)
    data[2] = 4.0
    data[3] = np.where(j < nx - 1, -1.0, 0.0)  # north (i, j+1)
    data[4] = np.where(i < nx - 1, -1.0, 0.0)  # east  (i+1, j)
    return offsets, data


def dia_to_torch_csr(torch, op):
    """The DIA operator's non-zeros as a torch CSR tensor (the library
    yardstick), and their number."""
    n = op.shape[0]
    i = torch.arange(n, device=op.data.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(op.offsets):
        j = i + off
        keep = (j >= 0) & (j < n) & (op.data[d] != 0)
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(op.data[d][keep])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    coo = torch.sparse_coo_tensor(idx, torch.cat(vals), op.shape).coalesce()
    return coo.to_sparse_csr(), int(idx.shape[1])


def cg_step_solve(torch, op, b, *, rtol: float, max_iterations: int,
                  check_every: int = CHECK_EVERY):
    """Unpreconditioned CG from x = 0 as a loop of ``cg_step``.

    √γ of every iteration goes into a preallocated device tensor, and the
    host reads the convergence test only every ``check_every`` iterations,
    so the loop adds no per-iteration sync.  Afterwards the first iteration
    whose √γ/√γ₀ is under ``rtol`` is found exactly (the rule of ``cg``).
    Returns (x, iterations to the tolerance, iterations run, converged,
    history of √γ); x is the iterate of the last iteration run."""
    from stormx_torch.ops.dia import cg_step

    x, r, p = torch.zeros_like(b), b.clone(), b.clone()
    gamma = torch.dot(r, r)
    hist = torch.full((max_iterations + 1,), float("nan"), dtype=b.dtype, device=b.device)
    torch.sqrt(gamma, out=hist[0])
    run = 0
    while run < max_iterations:
        x, r, p, gamma = cg_step(op, x, r, p, gamma)
        run += 1
        torch.sqrt(gamma, out=hist[run])
        if run % check_every == 0 and bool((hist[1: run + 1] / hist[0] < rtol).any()):
            break
    under = torch.nonzero(hist[1: run + 1] / hist[0] < rtol)
    converged = under.numel() > 0
    iterations = int(under[0, 0]) + 1 if converged else run
    return x, iterations, run, converged, hist[: iterations + 1]


def true_residual(torch, op, x, b) -> float:
    """‖b − A·x‖/‖b‖ in float64 with the plain DIA matvec, on x's device."""
    from stormx_torch.ops.dia import dia_spmv_plain
    from stormx_torch.sparse.formats import DIA

    op64 = DIA(data=op.data.double(), offsets=op.offsets, shape=op.shape)
    b64 = b.double()
    r = b64 - dia_spmv_plain(op64, x.double())
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def run_smoke(torch, dev, side: int) -> dict:
    from stormx_torch.apps.cahn_hilliard import make_assembled_step, make_step, run
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops import _cuda, banded_gather, sell_spmv
    from stormx_torch.precond import JacobiPreconditioner
    from stormx_torch.solvers import SolverOptions, cg, make_operator
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import SlicedELL, auto_operator

    f32, f64 = torch.float32, torch.float64

    # -- 1. device and kernel build ------------------------------------
    smi = nvidia_smi()
    build_s = _cuda.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _cuda.build_log.items()
    }
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)

    # -- 2. mesh -------------------------------------------------------------
    t0 = time.perf_counter()
    pts, tris = delaunay_mesh(side, JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    mesh_s = time.perf_counter() - t0
    areas = np.sort(mesh.cell_volumes)
    emit("mesh", cells=mesh.num_cells, faces=mesh.num_faces, nodes=mesh.num_nodes,
         min_over_median_area=float(areas[0] / areas[len(areas) // 2]), host_s=mesh_s)

    # -- 3. kernels against their plain versions ---------------------------
    t0 = time.perf_counter()
    ch_opts = SolverOptions(**CH_OPTIONS)
    step = make_assembled_step(mesh, dtype=f32, device=dev, options=ch_opts)
    ch_build_s = time.perf_counter() - t0
    op, dmesh = step.operator, step.dmesh
    require(isinstance(op, SlicedELL) and op.mode == "cuda",
            f"the CH operator is {type(op).__name__}/{getattr(op, 'mode', None)}, not the kernel mode")
    plans = {name: getattr(dmesh, "bg_" + name)
             for name in ("face_inner", "face_outer", "cell_face", "cell_adj")}
    require(all(p is not None for p in plans.values()), "a banded-gather plan is missing")
    require(not any(p.xla_fallback for p in plans.values()),
            "a banded-gather plan fell back to the plain gather")
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=f32, device=dev)  # 128 MB > L2
    gen = torch.Generator(device="cpu").manual_seed(1)
    kernels = []

    x = torch.randn(op.shape[1], generator=gen, dtype=f32).to(dev)
    y_k = sell_spmv.sell_spmv_cuda(op, x)
    y_p = sell_spmv.sell_spmv_plain(op, x)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    scale = float(y_p.abs().max())
    require(err <= 1e-5 * scale, f"K1 differs from its plain version: {err} > 1e-5·{scale}")
    op_csr = sell_to_csr(op)
    a_csr, nnz = torch_csr(torch, op_csr, dev), int(op_csr.nnz)
    nb, K, R = op.data.shape
    b_ms, b_by = bound_ms(8.0 * nnz + 4.0 * (op.shape[0] + op.shape[1]), 2.0 * nnz)
    kernels.append(dict(
        name="sell_spmv", route="cuda", source="stormx_torch/csrc/sell_spmv.cu",
        replaces="stormx/ops/pallas_sell.py:64", tpu_source="stormx/ops/pallas_sell.py:_kernel",
        shape=dict(rows=op.shape[0], nnz=nnz, K=K, R=R, window=op.window),
        ok=True, max_abs_err=err, max_err=err, max_abs_y=scale,
        ms=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(op, x)),
        ms_l2_flushed=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(op, x), flush=flush),
        plain_ms=time_ms(torch, lambda: sell_spmv.sell_spmv_plain(op, x)),
        library_ms=time_ms(torch, lambda: a_csr @ x),
        library_call="torch.sparse_csr_tensor @ x",
        bound_ms=b_ms, bound_by=b_by,
    ))
    del a_csr

    for name, plan in plans.items():
        xg = torch.randn(plan.n_src, generator=gen, dtype=f32).to(dev)
        idx = torch.as_tensor(
            {"face_inner": mesh.face_cells[:, 0],
             "face_outer": np.where(mesh.face_cells[:, 1] >= 0, mesh.face_cells[:, 1],
                                    mesh.face_cells[:, 0]),
             "cell_face": dmesh.cell_face_ell.reshape(-1).cpu().numpy(),
             "cell_adj": dmesh.cell_adj_ell.reshape(-1).cpu().numpy()}[name],
            dtype=torch.int64, device=dev)
        g_k = banded_gather.banded_gather_cuda(plan, xg)
        g_p = banded_gather.banded_gather_plain(plan, xg)
        g_l = torch.index_select(xg, 0, idx)
        torch.cuda.synchronize()
        require(torch.equal(g_k, g_p), f"K3 {name} differs from its plain version")
        require(torch.equal(g_k, g_l), f"K3 {name} differs from x[idx]")
        g_err = float((g_k - g_p).abs().max())
        per_call, traces = cuda_kernels_in(
            torch, lambda: banded_gather.banded_gather_cuda(plan, xg), dev)
        require(len(per_call) == 1, f"K3 {name} launched {per_call} in one call, not one kernel")
        b_ms, b_by = bound_ms(4.0 * plan.m + 4.0 * plan.n_src + 4.0 * plan.m, 0.0)
        kernels.append(dict(
            name=f"banded_gather/{name}", route="cuda",
            source="stormx_torch/csrc/banded_gather.cu",
            replaces="stormx/ops/pallas_gather.py:40",
            tpu_source="stormx/ops/pallas_gather.py:_kernel",
            shape=dict(m=plan.m, n_src=plan.n_src, window=plan.window,
                       fixups=int(plan.fix_pos.numel())),
            ok=True, max_abs_err=g_err, max_err=g_err, cuda_kernels_per_call=len(per_call),
            profiler_traces=traces,
            ms=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, xg)),
            ms_l2_flushed=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, xg),
                                  flush=flush),
            plain_ms=time_ms(torch, lambda: banded_gather.banded_gather_plain(plan, xg)),
            library_ms=time_ms(torch, lambda: torch.index_select(xg, 0, idx)),
            library_call="torch.index_select(x, 0, idx)",
            bound_ms=b_ms, bound_by=b_by,
        ))
    # A complex128 field through one plan: K3 moves its 16-byte items as two
    # 8-byte words, bit-exact, in one launch.
    plan = plans["face_inner"]
    xc = torch.complex(torch.randn(plan.n_src, generator=gen, dtype=f64),
                       torch.randn(plan.n_src, generator=gen, dtype=f64)).to(dev)
    g_k = banded_gather.banded_gather_cuda(plan, xc)
    g_p = banded_gather.banded_gather_plain(plan, xc)
    torch.cuda.synchronize()
    require(torch.equal(torch.view_as_real(g_k).view(torch.int64),
                        torch.view_as_real(g_p).view(torch.int64)),
            "K3 differs from its plain version on a complex128 field")
    per_call, traces = cuda_kernels_in(
        torch, lambda: banded_gather.banded_gather_cuda(plan, xc), dev)
    require(len(per_call) == 1, f"K3 launched {per_call} for a complex128 field")
    idx = torch.as_tensor(mesh.face_cells[:, 0], dtype=torch.int64, device=dev)
    complex128 = dict(plan="face_inner", bit_exact=True, cuda_kernels_per_call=len(per_call),
                      profiler_traces=traces,
                      ms=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, xc)),
                      library_ms=time_ms(torch, lambda: torch.index_select(xc, 0, idx)))
    del flush, xc, g_k, g_p
    emit("kernel_check", kernels=[{k: v for k, v in e.items()} for e in kernels],
         complex128=complex128)
    # The card's fixed cost per launch: an empty kernel on one block and on
    # K3's grid (one block per 512 rows), beside K3's times and bounds.
    k3 = [e for e in kernels if e["name"].startswith("banded_gather/")]
    emit("launch_cost",
         empty_kernel_ms=time_ms(torch, lambda: banded_gather.empty_launch(1, dev)),
         empty_kernel_ms_on_k3_grid={
             e["name"]: time_ms(torch, lambda p=plans[e["name"].split("/")[1]]:
                                banded_gather.empty_launch(p.starts.numel(), dev))
             for e in k3},
         k3={e["name"]: dict(ms=e["ms"], bound_ms=e["bound_ms"], library_ms=e["library_ms"])
             for e in k3})

    # -- 4. the app ----------------------------------------------------------
    rng = np.random.default_rng(0)
    c0_np = 0.5 + 0.1 * rng.standard_normal(mesh.num_cells)
    c0 = torch.as_tensor(c0_np, dtype=f32, device=dev)
    sell_spmv.launches = 0
    banded_gather.launches = 0
    for p in plans.values():
        p.launches = 0
    c, steps = c0, []
    for _ in range(CH_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        c, res = step(c)
        end.record()
        end.synchronize()
        steps.append(dict(ms=start.elapsed_time(end), cg_iterations=res.num_iterations,
                          converged=res.converged, relative_error=float(res.relative_error)))
        if len(steps) == 1:
            c1 = c
    c_run = run(dmesh, c0, CH_STEPS, mesh=mesh, assembled=True, device=dev,
                options=ch_opts)
    torch.cuda.synchronize()
    app_launches = dict(sell_spmv=sell_spmv.launches, banded_gather=banded_gather.launches,
                        plans={n: p.launches for n, p in plans.items()})
    require(sell_spmv.launches > 0, "K1 was not launched in the app phase")
    require(banded_gather.launches > 0, "K3 was not launched in the app phase")
    require(all(s["converged"] for s in steps), f"a CH step's CG did not converge: {steps}")
    c_np = c.double().cpu().numpy()
    require(np.isfinite(c_np).all(), "c is not finite")
    require(c_np.min() > -0.5 and c_np.max() < 1.5, "c left (-0.5, 1.5)")
    run_gap = float((c_run - c).abs().max())
    require(run_gap <= 1e-6, f"run() differs from the stepped march by {run_gap}")

    t0 = time.perf_counter()
    step_cpu = make_assembled_step(mesh, dtype=f64, device="cpu", options=ch_opts)
    c1_cpu, res_cpu = step_cpu(torch.as_tensor(c0_np, dtype=f64))
    cpu_s = time.perf_counter() - t0
    gap = float((c1.double().cpu() - c1_cpu).abs().max())
    it_gpu, it_cpu = steps[0]["cg_iterations"], res_cpu.num_iterations
    require(res_cpu.converged, "the CPU float64 reference step did not converge")
    require(gap <= CH_GAP, f"GPU step 1 differs from the CPU float64 step by {gap}")
    require(abs(it_gpu - it_cpu) <= 0.1 * it_cpu,
            f"CG iterations {it_gpu} (GPU f32) vs {it_cpu} (CPU f64) differ by more than 10%")

    mf_step = make_step(dmesh, device=dev, options=ch_opts)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    k3_before = banded_gather.launches
    start.record()
    c1_mf, res_mf = mf_step(c0)
    end.record()
    end.synchronize()
    mf_gap = float((c1_mf - c1).abs().max())
    require(res_mf.converged, "the matrix-free CH step did not converge")
    require(mf_gap <= CH_GAP, f"matrix-free step 1 differs from the assembled one by {mf_gap}")
    emit("app", cells=mesh.num_cells, operator=dict(mode=op.mode, nnz=nnz, K=K, R=R,
                                                    window=op.window),
         host_build_s=ch_build_s, steps=steps,
         ms_per_step=statistics.mean(s["ms"] for s in steps),
         launches=app_launches,
         k1_launches_per_step=app_launches["sell_spmv"] / (2 * CH_STEPS),
         run_gap=run_gap,
         cpu_f64=dict(cg_iterations=it_cpu, max_abs_gap=gap, seconds=cpu_s,
                      mode=getattr(step_cpu.operator, "mode", None)),
         matrix_free=dict(ms=start.elapsed_time(end), cg_iterations=res_mf.num_iterations,
                          k3_launches=banded_gather.launches - k3_before,
                          max_abs_gap=mf_gap))
    main_launches = {"sell_spmv": sell_spmv.launches}
    main_launches.update({f"banded_gather/{n}": p.launches for n, p in plans.items()})
    del step, step_cpu, mf_step

    # -- 5. Milestone A ------------------------------------------------------
    t0 = time.perf_counter()
    L = assemble_laplacian(mesh)
    Lc = L.to_csr()
    Lc32 = CSR(data=Lc.data.to(f32), indices=Lc.indices, row_ptr=Lc.row_ptr, shape=Lc.shape)
    lop, perm = auto_operator(Lc32, coords=mesh.cell_centers, device=dev)
    require(isinstance(lop, SlicedELL) and lop.mode == "cuda",
            "the Laplacian did not resolve to the kernel mode")
    centers = mesh.cell_centers
    rhs = mesh.cell_volumes * np.sin(2 * np.pi * centers[:, 0]) * np.cos(2 * np.pi * centers[:, 1])
    rhs = rhs - rhs.mean()
    diag = L.diagonal().numpy()
    b = torch.as_tensor(rhs[perm], dtype=f32, device=dev)
    jac = JacobiPreconditioner(diag=torch.as_tensor(diag[perm], dtype=f32, device=dev))
    opts = SolverOptions(num_iterations=10_000, absolute_tolerance=0.0,
                         relative_tolerance=POISSON_RTOL)
    poisson_build_s = time.perf_counter() - t0
    sell_spmv.launches = 0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = cg(make_operator(lop.matvec), b, torch.zeros_like(b), precond=jac, options=opts)
    end.record()
    end.synchronize()
    solve_ms = start.elapsed_time(end)
    k1_poisson = sell_spmv.launches
    require(k1_poisson > 0, "K1 was not launched in the Poisson phase")
    require(res.converged, f"Milestone-A CG did not converge in {res.num_iterations} iterations")
    x = np.empty(mesh.num_cells)
    x[perm] = res.x.double().cpu().numpy()

    def true_residual(xv):
        r = L.matvec(torch.as_tensor(xv)).numpy() - rhs
        return float(np.linalg.norm(r) / np.linalg.norm(rhs))

    true_res = true_residual(x)
    require(true_res <= POISSON_TRUE_RES,
            f"Milestone-A true residual {true_res} > {POISSON_TRUE_RES}·‖b‖")

    # The same solve on the CPU in float64, to a relative tolerance of 1e-8.
    t0 = time.perf_counter()
    lop64, perm64 = auto_operator(Lc, coords=mesh.cell_centers, device="cpu")
    res64 = cg(make_operator(lop64.matvec), torch.as_tensor(rhs[perm64]),
               torch.zeros(mesh.num_cells, dtype=f64),
               precond=JacobiPreconditioner(diag=torch.as_tensor(diag[perm64])),
               options=SolverOptions(num_iterations=10_000, absolute_tolerance=0.0,
                                     relative_tolerance=1e-8))
    x64 = np.empty(mesh.num_cells)
    x64[perm64] = res64.x.numpy()
    true_res64 = true_residual(x64)
    require(res64.converged and true_res64 <= 1.1e-8,
            f"the CPU float64 Poisson solve failed: {res64.num_iterations} iterations, "
            f"true residual {true_res64}")
    dx = (x - x.mean()) - (x64 - x64.mean())
    emit("poisson", cells=mesh.num_cells, nnz=int(Lc.nnz), operator_mode=lop.mode,
         host_build_s=poisson_build_s, cg_iterations=res.num_iterations,
         relative_tolerance=POISSON_RTOL,
         solve_ms=solve_ms, ms_per_iteration=solve_ms / max(res.num_iterations, 1),
         relative_error=float(res.relative_error), true_relative_residual=true_res,
         k1_launches=k1_poisson, k1_launches_per_iteration=k1_poisson / max(res.num_iterations, 1),
         cpu_f64=dict(cg_iterations=res64.num_iterations, true_relative_residual=true_res64,
                      mode=getattr(lop64, "mode", None), seconds=time.perf_counter() - t0,
                      relative_solution_gap=float(np.linalg.norm(dx)
                                                  / np.linalg.norm(x64 - x64.mean()))))
    main_launches["sell_spmv"] += k1_poisson
    emit("profile", **profile_cg(torch, lambda: cg(
        make_operator(lop.matvec), b, torch.zeros_like(b), precond=jac,
        options=SolverOptions(num_iterations=PROFILE_ITERATIONS, absolute_tolerance=0.0,
                              relative_tolerance=0.0))))

    kernels = [e for e in kernels if e["name"] in ON_PATH]
    for e in kernels:
        e["launches"] = main_launches[e["name"]]
        e["kernel_ms"] = e["ms"]
        require(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    # What the packed phases (11-13) take over from phases 3 and 5.
    packed_ctx = dict(ch_op=op, laplacian_op=lop, laplacian=L, perm=perm, b=b, jac=jac,
                      true_residual=true_residual, poisson_iterations=res.num_iterations,
                      poisson_ms_per_iteration=solve_ms / max(res.num_iterations, 1),
                      poisson_options=opts)
    return dict(kernels=kernels, smi=smi, packed_ctx=packed_ctx)


def _finite(v):
    """A float, or None where it is not finite (JSON has no NaN)."""
    v = float(v)
    return v if np.isfinite(v) else None


def _cuda_ms(torch, fn):
    """(fn(), device ms) with CUDA events around one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_banded(torch, dev, nx: int, fvm_side: int) -> list:
    """Phases 7-10, the banded path.  Returns the K2 entries of the
    ``kernels`` line, with their launches on the path."""
    from stormx_torch.fvm.divgrad import assemble_divgrad, assemble_divgrad_dia
    from stormx_torch.mesh import structured_tri_rect
    from stormx_torch.ops import dia as k2
    from stormx_torch.precond import BlockDiaAmg
    from stormx_torch.solvers import SolverOptions, solve
    from stormx_torch.sparse.formats import DIA, ELL

    f32 = torch.float32

    def reset():
        for k in k2.launches:
            k2.launches[k] = 0

    t0 = time.perf_counter()
    offsets, data = poisson5_diags(nx)
    n = nx * nx
    op = DIA(data=torch.as_tensor(data, device=dev), offsets=offsets, shape=(n, n))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n).astype(np.float32),
                        device=dev)
    host_s = time.perf_counter() - t0

    # -- 7. K2a and K2b against their plain versions ----------------------
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=f32, device=dev)  # 128 MB > L2
    gen = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(n, generator=gen, dtype=f32).to(dev)
    n_diags = op.num_diags
    a_csr, nnz = dia_to_torch_csr(torch, op)
    z_k = k2.dia_spmv_cuda(op, x)
    z_d, pz_k = k2.dia_spmv_dots_cuda(op, x)
    z_p, pz_p = k2.dia_spmv_dots_plain(op, x)
    torch.cuda.synchronize()
    z_scale = float(z_p.abs().max())
    z_err, zd_err = float((z_k - z_p).abs().max()), float((z_d - z_p).abs().max())
    dot_scale = float((x * z_p).abs().sum())
    dot_err = abs(float(pz_k) - float(pz_p))
    require(z_err <= 1e-5 * z_scale, f"K2a differs from its plain version: {z_err}")
    require(zd_err <= 1e-5 * z_scale, f"K2a with the dot differs in z: {zd_err}")
    require(dot_err <= 1e-5 * dot_scale, f"K2a's <p,z> differs: {dot_err} > 1e-5·{dot_scale}")
    spmv_bytes = 4.0 * (n_diags + 2) * n  # the diagonals, x once, z once
    shape = dict(rows=n, diags=n_diags, offsets=list(offsets), nnz=nnz)
    spmv = dict(route="cuda", source="stormx_torch/csrc/dia_spmv.cu",
                replaces="stormx/ops/pallas_dia.py:99",
                tpu_source="stormx/ops/pallas_dia.py:_spmv_kernel", shape=shape, ok=True)
    b_ms, b_by = bound_ms(spmv_bytes, 2.0 * nnz)
    kernels = [dict(
        name="dia_spmv", **spmv, max_abs_err=z_err, max_err=z_err, max_abs_z=z_scale,
        ms=time_ms(torch, lambda: k2.dia_spmv_cuda(op, x)),
        ms_l2_flushed=time_ms(torch, lambda: k2.dia_spmv_cuda(op, x), flush=flush),
        plain_ms=time_ms(torch, lambda: k2.dia_spmv_plain(op, x)),
        library_ms=time_ms(torch, lambda: a_csr @ x),
        library_call="torch.sparse_csr_tensor @ x", bound_ms=b_ms, bound_by=b_by,
    )]
    del a_csr
    b_ms, b_by = bound_ms(spmv_bytes + 4.0, 2.0 * nnz + 2.0 * n)
    kernels.append(dict(
        name="dia_spmv_dots", **spmv, max_abs_err=zd_err, max_err=zd_err, dot_abs_err=dot_err,
        dot_scale=dot_scale,
        ms=time_ms(torch, lambda: k2.dia_spmv_dots_cuda(op, x)),
        ms_l2_flushed=time_ms(torch, lambda: k2.dia_spmv_dots_cuda(op, x), flush=flush),
        plain_ms=time_ms(torch, lambda: k2.dia_spmv_dots_plain(op, x)),
        library_ms=None, library_call=None, bound_ms=b_ms, bound_by=b_by,
    ))

    xv, rv, pv, zv = (torch.randn(n, generator=gen, dtype=f32).to(dev) for _ in range(4))
    alpha = torch.tensor(0.37, dtype=f32, device=dev)
    x_k, r_k, rr_k = k2.cg_fused_update_cuda(alpha, xv, rv, pv, zv)
    x_p, r_p, rr_p = k2.cg_fused_update_plain(alpha, xv, rv, pv, zv)
    torch.cuda.synchronize()
    x_err, r_err = float((x_k - x_p).abs().max()), float((r_k - r_p).abs().max())
    rr_rel = abs(float(rr_k) - float(rr_p)) / float(rr_p)
    require(x_err <= 1e-6 * float(x_p.abs().max()), f"K2b's x differs: {x_err}")
    require(r_err <= 1e-6 * float(r_p.abs().max()), f"K2b's r differs: {r_err}")
    require(rr_rel <= 1e-5, f"K2b's <r,r> differs by {rr_rel} relative")
    b_ms, b_by = bound_ms(24.0 * n + 8.0, 6.0 * n)  # read x, r, p, z and α; write x, r, γ
    kernels.append(dict(
        name="cg_fused_update", route="cuda", source="stormx_torch/csrc/cg_update.cu",
        replaces="stormx/ops/pallas_dia.py:211",
        tpu_source="stormx/ops/pallas_dia.py:_update_kernel", shape=dict(n=n), ok=True,
        max_abs_err=max(x_err, r_err), max_err=max(x_err, r_err), rr_rel_err=rr_rel,
        ms=time_ms(torch, lambda: k2.cg_fused_update_cuda(alpha, xv, rv, pv, zv)),
        ms_l2_flushed=time_ms(torch, lambda: k2.cg_fused_update_cuda(alpha, xv, rv, pv, zv),
                              flush=flush),
        plain_ms=time_ms(torch, lambda: k2.cg_fused_update_plain(alpha, xv, rv, pv, zv)),
        library_ms=None, library_call=None, bound_ms=b_ms, bound_by=b_by,
    ))
    del flush, xv, rv, pv, zv, x_k, r_k, x_p, r_p

    # K2a on the FVM route, against the ELL form of the same operator.
    t0 = time.perf_counter()
    mesh = structured_tri_rect(fvm_side, fvm_side)
    fdia, fperm = assemble_divgrad_dia(mesh, device=dev)
    ell = assemble_divgrad(mesh)
    fvm_build_s = time.perf_counter() - t0
    perm = torch.as_tensor(fperm, device=dev)
    xf = torch.randn(mesh.num_cells, generator=gen, dtype=torch.float64).to(dev)
    fvm_checks = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        fd = DIA(data=fdia.data.to(dtype), offsets=fdia.offsets, shape=fdia.shape)
        fe = ELL(data=ell.data.to(device=dev, dtype=dtype), cols=ell.cols.to(dev),
                 shape=ell.shape)
        xd = xf.to(dtype)
        xp = xd[perm].contiguous()
        y_dia, y_ell = fd.matvec(xp), fe.matvec(xd)[perm]
        torch.cuda.synchronize()
        err, scale = float((y_dia - y_ell).abs().max()), float(y_ell.abs().max())
        require(err <= tol * scale, f"K2a on the FVM route ({dtype}) differs from ELL: {err}")
        fvm_checks[str(dtype)] = dict(max_abs_err=err, max_abs_y=scale, tolerance=tol,
                                      ms=time_ms(torch, lambda: k2.dia_spmv_cuda(fd, xp)))
    emit("banded_kernel_check", rows=n, offsets=list(offsets), host_build_s=host_s,
         kernels=kernels,
         fvm_route=dict(mesh=f"structured_tri_rect({fvm_side}, {fvm_side})",
                        cells=mesh.num_cells, offsets=list(fdia.offsets),
                        host_build_s=fvm_build_s, checks=fvm_checks))
    del mesh, fdia, ell, xf, perm
    main_launches = dict.fromkeys(k2.launches, 0)

    def count():
        for k, c in k2.launches.items():
            main_launches[k] += c
        return dict(k2.launches)

    # -- 8. CG through solve and through cg_step ------------------------------
    opts = SolverOptions(num_iterations=CG_MAX_ITERATIONS, absolute_tolerance=0.0,
                         relative_tolerance=BANDED_RTOL)
    reset()
    res_a, ms_a = _cuda_ms(torch, lambda: solve(op, b, method="cg", options=opts))
    launches_a = count()
    reset()
    (x_b, it_b, run_b, conv_b, hist_b), ms_b = _cuda_ms(torch, lambda: cg_step_solve(
        torch, op, b, rtol=BANDED_RTOL, max_iterations=CG_MAX_ITERATIONS))
    launches_b = count()
    it_a = res_a.num_iterations
    tr_a, tr_b = true_residual(torch, op, res_a.x, b), true_residual(torch, op, x_b, b)
    prof_a = profile_cg(torch, lambda: solve(op, b, method="cg", options=SolverOptions(
        num_iterations=PROFILE_ITERATIONS, absolute_tolerance=0.0, relative_tolerance=0.0)))
    prof_b = profile_cg(torch, lambda: cg_step_solve(torch, op, b, rtol=0.0,
                                                     max_iterations=PROFILE_ITERATIONS))
    failures = []
    if not (res_a.converged and conv_b):
        failures.append("a banded CG run did not converge")
    if abs(it_a - it_b) > 0.02 * max(it_a, it_b):
        failures.append(f"iteration counts {it_a} (solve) and {it_b} (cg_step) differ by > 2%")
    if tr_a > BANDED_CG_TRUE_RES or tr_b > BANDED_CG_TRUE_RES:
        failures.append(f"true residuals {tr_a}, {tr_b} > {BANDED_CG_TRUE_RES}")
    emit("banded_cg", rows=n, relative_tolerance=BANDED_RTOL, true_residual_gate=BANDED_CG_TRUE_RES,
         solve=dict(iterations=it_a, converged=res_a.converged, ms=ms_a,
                    ms_per_iteration=ms_a / max(it_a, 1),
                    relative_error=float(res_a.relative_error), true_relative_residual=tr_a,
                    launches=launches_a,
                    k2a_launches_per_iteration=launches_a["dia_spmv"] / max(it_a, 1),
                    profile=prof_a),
         cg_step=dict(iterations=it_b, iterations_run=run_b, converged=conv_b, ms=ms_b,
                      ms_per_iteration=ms_b / max(run_b, 1), check_every=CHECK_EVERY,
                      relative_error=float(hist_b[-1] / hist_b[0]),
                      true_relative_residual=tr_b, launches=launches_b,
                      k2a_launches_per_iteration=launches_b["dia_spmv_dots"] / max(run_b, 1),
                      k2b_launches_per_iteration=launches_b["cg_fused_update"] / max(run_b, 1),
                      profile=prof_b),
         failures=failures)
    require(not failures, "; ".join(failures))
    del res_a, x_b

    # -- 9. CG + BlockDiaAmg ---------------------------------------------------
    t0 = time.perf_counter()
    amg = BlockDiaAmg(op, **AMG_OPTIONS)
    torch.cuda.synchronize()
    amg_setup_s = time.perf_counter() - t0
    reset()
    amg(b)
    torch.cuda.synchronize()
    per_vcycle = k2.launches["dia_spmv"]
    reset()
    res, ms = _cuda_ms(torch, lambda: solve(op, b, method="cg", precond=amg, options=opts))
    launches = count()
    tr = true_residual(torch, op, res.x, b)
    failures = []
    if not res.converged:
        failures.append(f"CG + BlockDiaAmg did not converge in {res.num_iterations} iterations")
    if tr > BANDED_AMG_TRUE_RES:
        failures.append(f"CG + BlockDiaAmg true residual {tr} > {BANDED_AMG_TRUE_RES}")
    emit("banded_amg", rows=n, options=AMG_OPTIONS, host_setup_s=amg_setup_s,
         levels=len(amg._levels), level_rows=[lv["n"] for lv in amg._levels],
         level_offsets=[list(lv["op"].offsets) for lv in amg._levels],
         coarse_rows=int(amg._coarse_inv.shape[0]), iterations=res.num_iterations,
         converged=res.converged, ms=ms, ms_per_iteration=ms / max(res.num_iterations, 1),
         relative_error=float(res.relative_error), true_relative_residual=tr,
         true_residual_gate=BANDED_AMG_TRUE_RES, k2a_launches=launches["dia_spmv"],
         k2a_launches_per_vcycle=per_vcycle, failures=failures)
    require(not failures, "; ".join(failures))
    del res

    # -- 10. the other Krylov methods with the same preconditioner -----------
    kopts = SolverOptions(num_iterations=KRYLOV_MAX_ITERATIONS, absolute_tolerance=0.0,
                          relative_tolerance=BANDED_RTOL)
    op64 = amg64 = None
    rows, failures = [], []
    for method in KRYLOV_METHODS:
        kw = KRYLOV_KWARGS.get(method, {})
        cap = KRYLOV_F32_CAP.get(method, KRYLOV_MAX_ITERATIONS)
        reset()
        res, ms = _cuda_ms(torch, lambda: solve(
            op, b, method=method, precond=amg,
            options=SolverOptions(num_iterations=cap, absolute_tolerance=0.0,
                                  relative_tolerance=BANDED_RTOL), **kw))
        launches = count()
        rel = (res.history[: res.num_iterations + 1] / res.history[0]).double().cpu().numpy()
        rel = np.where(np.isfinite(rel), rel, np.inf)
        row = dict(method=method, max_iterations=cap, iterations=res.num_iterations,
                   converged=res.converged, ms=ms, ms_per_iteration=ms / max(res.num_iterations, 1),
                   relative_error=_finite(rel[-1]), best_relative_error=float(rel.min()),
                   best_iteration=int(rel.argmin()),
                   true_relative_residual=_finite(true_residual(torch, op, res.x, b)),
                   k2a_launches=launches["dia_spmv"])
        del res
        if method in KRYLOV_TRUE_RES:
            row["gate"] = f"converged, true residual <= {KRYLOV_TRUE_RES[method]}"
            if not (row["converged"] and row["true_relative_residual"] is not None
                    and row["true_relative_residual"] <= KRYLOV_TRUE_RES[method]):
                failures.append(f"{method}: {row}")
        else:
            # The float64 rerun, on the same operator and card: a diagnosis,
            # not the path, so its launches are not counted.
            if op64 is None:
                op64 = DIA(data=op.data.double(), offsets=op.offsets, shape=op.shape)
                amg64 = BlockDiaAmg(op64, **AMG_OPTIONS)
            res64, ms64 = _cuda_ms(torch, lambda: solve(op64, b.double(), method=method,
                                                        precond=amg64, options=kopts, **kw))
            row["float64"] = dict(iterations=res64.num_iterations, converged=res64.converged,
                                  ms=ms64, relative_error=float(res64.relative_error),
                                  true_relative_residual=true_residual(torch, op64, res64.x,
                                                                       b.double()))
            del res64
            if method == "richardson":
                row["gate"] = (f"relative residual after {KRYLOV_MAX_ITERATIONS} iterations "
                               f"<= {RICHARDSON_REACH} in float32 and float64")
                ok = max(rel[-1], row["float64"]["relative_error"]) <= RICHARDSON_REACH
            else:
                row["gate"] = (f"float32 breakdown: best relative residual in {cap} iterations "
                               f"<= {KRYLOV_F32_BEST[method]}; converges in float64")
                ok = rel.min() <= KRYLOV_F32_BEST[method] and row["float64"]["converged"]
            if not ok:
                failures.append(f"{method}: {row}")
        rows.append(row)
    emit("krylov", rows=n, precond=f"BlockDiaAmg{AMG_OPTIONS}", relative_tolerance=BANDED_RTOL,
         max_iterations=KRYLOV_MAX_ITERATIONS, kwargs=KRYLOV_KWARGS, methods=rows,
         failures=failures)
    require(not failures, "; ".join(failures))

    for e in kernels:
        e["launches"] = main_launches[e["name"]]
        e["kernel_ms"] = e["ms"]
        require(e["launches"] > 0, f"{e['name']} was not launched on the banded path")
    return kernels


def gather_check(torch, k4, packed, x, y_p, name: str) -> dict:
    """K4b's branch for ``packed`` against its plain version ``y_p`` (within
    1e-5·max|y|), and each branch that fits the card (the per-row kernel
    always) non-finite in exactly the plain version's rows with Inf at x[3]
    and at the window start of the first block b ≥ 1 whose start b·R − pad_lo
    lies in x: there the dead entries of block b read."""
    nb, M, _ = packed.vals.shape
    R, pad_lo = packed.block_rows, packed.pad_lo
    start = max(1, -(-pad_lo // R)) * R - pad_lo
    require(start < x.shape[0], f"no block's window starts inside x on {name}")
    branch = k4.gather_branch(packed)
    scale = float(y_p.abs().max())
    errs = {}
    for b in ("staged", "rows") if branch == "staged" else ("rows",):
        errs[b] = float((k4.packed_spmv_cuda(packed, x, branch=b) - y_p).abs().max())
        require(errs[b] <= 1e-5 * scale, f"K4b {b} differs from its plain version on {name}")
    nonfinite = {}
    for pos in (3, start):
        xi = x.clone()
        xi[pos] = float("inf")
        want = nonfinite_rows(torch, k4.packed_spmv_plain(packed, xi))
        for b in errs:
            got = nonfinite_rows(torch, k4.packed_spmv_cuda(packed, xi, branch=b))
            require(torch.equal(got, want),
                    f"K4b {b} on {name}: non-finite rows differ from the plain version's"
                    f" with Inf at x[{pos}]")
        nonfinite[str(pos)] = int(want.numel())
    blocks = k4.gather_blocks_per_sm(packed) if branch == "staged" else None
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return dict(branch=branch, max_abs_err_by_branch=errs, nonfinite_rows_by_inf_at=nonfinite,
                staged_smem_bytes=k4.staged_smem_bytes(M),
                blocks_per_sm=blocks, waves=nb / (blocks * sms) if blocks else None,
                read_bytes=k4b_read_bytes(torch, packed))


def run_packed(torch, dev, ctx: dict, k2a: dict) -> list:
    """Phases 11-13, the packed path.  Returns the K4a, K4b, P1 and P2
    entries of the ``kernels`` line, with their launches on the path."""
    from stormx_torch.ops import probes, sell_spmv
    from stormx_torch.ops import sell_packed as k4
    from stormx_torch.solvers import (SolverOptions, bicgstab, cg, jfnk, make_operator, newton,
                                      solve)
    from stormx_torch.sparse.windowed import sell_from_csr

    f32, f64 = torch.float32, torch.float64

    def reset():
        for counts in (k4.launches, probes.launches):
            for k in counts:
                counts[k] = 0

    # -- 11. K4a, K4b, P1 and P2 against their plain versions ----------------
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=f32, device=dev)  # 128 MB > L2
    gen = torch.Generator(device="cpu").manual_seed(3)
    reset()
    rows, packed_ops, kernels = [], {}, []
    for name, base, heights in (
            ("ch", ctx["ch_op"], (PACKED_BLOCK_ROWS,)),
            ("laplacian", ctx["laplacian_op"], (PACKED_BLOCK_ROWS, PACKED_CHECK_BLOCK_ROWS))):
        csr = sell_to_csr(base)
        nnz = int(csr.nnz)
        n = csr.shape[0]
        a_csr = torch_csr(torch, csr, dev)
        x = torch.randn(n, generator=gen, dtype=f32).to(dev)
        for R in heights:
            sell, _ = sell_from_csr(csr, block_rows=R, mode="cuda", reorder=False, device=dev)
            y_k1 = sell_spmv.sell_spmv_cuda(sell, x)
            for variant in k4.VARIANTS:
                t0 = time.perf_counter()
                packed = k4.pack_sell(sell, variant)
                torch.cuda.synchronize()
                pack_s = time.perf_counter() - t0
                y_k = k4.packed_spmv_cuda(packed, x)
                y_p = k4.packed_spmv_plain(packed, x)
                torch.cuda.synchronize()
                scale = float(y_p.abs().max())
                err = float((y_k - y_p).abs().max())
                err_k1 = float((y_k - y_k1).abs().max())
                require(err <= 1e-5 * scale,
                        f"K4 {variant} differs from its plain version on {name} at R={R}: {err}")
                require(err_k1 <= 1e-5 * scale,
                        f"K4 {variant} differs from K1 on {name} at R={R}: {err_k1}")
                nb, M, _ = packed.vals.shape
                slots = nb * M * 128
                row = dict(operator=name, R=R, variant=variant, rows=n, nnz=nnz, nb=nb, M=M,
                           K=packed.ell_k, C=packed.window, slot_fill=nnz / slots,
                           pack_s=pack_s, max_abs_err=err, max_abs_err_vs_k1=err_k1,
                           max_abs_y=scale)
                if variant == "matmul":
                    row["read_bytes"] = k4a_read_bytes(torch, packed)
                    packed_bytes = 8.0 * slots + 8.0 * n
                else:
                    row.update(gather_check(torch, k4, packed, x, y_p, name))
                    packed_bytes = row["read_bytes"]["total"]
                if R == PACKED_BLOCK_ROWS:
                    # The bound counts what y = A·x needs (live nonzeros, x and
                    # y once), as K1's does; the packed tiles' own bytes (K4a:
                    # every slot's value and word; K4b: what its staged
                    # branch reads, k4b_read_bytes) are beside it.
                    b_ms, b_by = bound_ms(8.0 * nnz + 8.0 * n, 2.0 * nnz)
                    row.update(
                        ms=time_ms(torch, lambda: k4.packed_spmv_cuda(packed, x)),
                        ms_l2_flushed=time_ms(torch, lambda: k4.packed_spmv_cuda(packed, x),
                                              flush=flush),
                        plain_ms=time_ms(torch, lambda: k4.packed_spmv_plain(packed, x)),
                        library_ms=time_ms(torch, lambda: a_csr @ x),
                        library_call="torch.sparse_csr_tensor @ x",
                        k1_ms=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(sell, x)),
                        bound_ms=b_ms, bound_by=b_by, packed_bytes=packed_bytes,
                        packed_bytes_ms=packed_bytes / H100_BYTES_PER_S * 1e3)
                    if variant == "gather":  # the per-row kernel, same inputs
                        rows_fn = lambda: k4.packed_spmv_cuda(packed, x, branch="rows")  # noqa: E731
                        row.update(rows_branch_ms=time_ms(torch, rows_fn),
                                   rows_branch_ms_l2_flushed=time_ms(torch, rows_fn,
                                                                     flush=flush))
                    packed_ops[(name, variant)] = packed
                    if name == "laplacian":  # the shapes of phases 12 and 13
                        kernels.append(dict(
                            name=f"packed_spmv/{variant}", route="cuda",
                            source="stormx_torch/csrc/sell_packed.cu",
                            replaces=("stormx/ops/pallas_sell2.py:132" if variant == "matmul"
                                      else "stormx/ops/pallas_sell2.py:82"),
                            tpu_source=("stormx/ops/pallas_sell2.py:_kernel" if variant == "matmul"
                                        else "stormx/ops/pallas_sell2.py:_kernel3"),
                            shape=dict(rows=n, nnz=nnz, R=R, nb=nb, M=M, K=packed.ell_k,
                                       C=packed.window, branch=row.get("branch")),
                            ok=True, max_abs_err=err, max_err=err, max_abs_y=scale,
                            **{k: row[k] for k in ("ms", "ms_l2_flushed", "plain_ms",
                                                   "library_ms", "library_call", "bound_ms",
                                                   "bound_by")}))
                rows.append(row)
        del a_csr

    # K4b's per-row branch, where the products exceed a block's shared memory.
    cfg = K4B_OVER_BUDGET
    csr = random_banded_csr(cfg["n"], cfg["K"], cfg["band"], seed=4)
    sell, _ = sell_from_csr(csr, block_rows=cfg["R"], mode="cuda", reorder=False, device=dev)
    packed = k4.pack_sell(sell, "gather")
    x = torch.randn(cfg["n"], generator=gen, dtype=f32).to(dev)
    y_p = k4.packed_spmv_plain(packed, x)
    y_k1 = sell_spmv.sell_spmv_plain(sell, x)
    check = gather_check(torch, k4, packed, x, y_p, "over_budget")
    scale = float(y_p.abs().max())
    err_k1 = float((k4.packed_spmv_cuda(packed, x) - y_k1).abs().max())
    require(check["branch"] == "rows", f"K4b took {check['branch']} at M = {packed.vals.shape[1]}")
    require(err_k1 <= 1e-5 * scale, f"K4b differs from K1's plain version over budget: {err_k1}")
    rows.append(dict(operator="over_budget", R=cfg["R"], variant="gather", rows=cfg["n"],
                     nnz=int(csr.nnz), nb=packed.vals.shape[0], M=packed.vals.shape[1],
                     K=packed.ell_k, C=packed.window, max_abs_err_vs_k1=err_k1,
                     max_abs_y=scale, **check))
    del sell, packed

    # P1 at the probe's shape and at one tile row per packed slot row of the
    # CH operator (K4a, R = 512).
    p1 = []
    ch = packed_ops[("ch", "matmul")]
    for n_rows in (P1_PROBE_ROWS, ch.vals.shape[0] * ch.vals.shape[1]):
        xg = torch.randn((n_rows, 128), generator=gen, dtype=f32).to(dev)
        idx = torch.randint(0, 128, (n_rows, 128), generator=gen, dtype=torch.int32).to(dev)
        idx64 = idx.long()
        y_k = probes.lane_gather_cuda(xg, idx)
        y_p = probes.lane_gather_plain(xg, idx)
        torch.cuda.synchronize()
        require(torch.equal(y_k, y_p), f"P1 differs from torch.gather at {n_rows} rows")
        b_ms, b_by = bound_ms(12.0 * n_rows * 128, 0.0)
        p1.append(dict(
            rows=n_rows, ok=True, max_abs_err=0.0,
            ms=time_ms(torch, lambda: probes.lane_gather_cuda(xg, idx)),
            ms_l2_flushed=time_ms(torch, lambda: probes.lane_gather_cuda(xg, idx), flush=flush),
            plain_ms=time_ms(torch, lambda: probes.lane_gather_plain(xg, idx)),
            library_ms=time_ms(torch, lambda: torch.gather(xg, 1, idx64)),
            library_call="torch.gather(x, 1, idx)", bound_ms=b_ms, bound_by=b_by))
    kernels.append(dict(
        name="lane_gather", route="cuda", source="stormx_torch/csrc/probes.cu",
        replaces="scripts/pallas_gather_probe.py:35",
        tpu_source="scripts/pallas_gather_probe.py:kernel",
        shape=dict(rows=p1[-1]["rows"], width=128), max_err=0.0,
        **{k: v for k, v in p1[-1].items() if k != "rows"}))

    # P2's four modes at the banded operator's length, beside K2a.
    n = P2_ROWS
    diag = torch.randn((probes.N_DIAGS, n), generator=gen, dtype=f32).to(dev)
    xs = torch.randn(n + probes.X_HALO, generator=gen, dtype=f32).to(dev)
    p2 = {}
    for mode in probes.STREAM_MODES:
        z_k = probes.dia_stream_probe_cuda(mode, P2_C, xs, diag)
        z_p = probes.dia_stream_probe_plain(mode, P2_C, xs, diag)
        torch.cuda.synchronize()
        err = float((z_k - z_p).abs().max())
        scale = float(z_p.abs().max())
        require(err <= 1e-6 * scale, f"P2 {mode} differs from its plain version: {err}")
        nbytes = probes.stream_bytes(mode, n)
        ms = time_ms(torch, lambda: probes.dia_stream_probe_cuda(mode, P2_C, xs, diag))
        ms_fl = time_ms(torch, lambda: probes.dia_stream_probe_cuda(mode, P2_C, xs, diag),
                        flush=flush)
        b_ms, b_by = bound_ms(nbytes, 2.0 * probes.N_DIAGS * n if mode == "full" else n)
        p2[mode] = dict(max_abs_err=err, bit_exact=bool(torch.equal(z_k, z_p)), bytes=nbytes,
                        ms=ms, ms_l2_flushed=ms_fl, gb_per_s=nbytes / ms / 1e6,
                        gb_per_s_l2_flushed=nbytes / ms_fl / 1e6, bound_ms=b_ms, bound_by=b_by,
                        plain_ms=time_ms(torch, lambda: probes.dia_stream_probe_plain(
                            mode, P2_C, xs, diag)))
    del diag, xs, flush
    k2a_bytes = 4.0 * (probes.N_DIAGS + 2) * n
    kernels.append(dict(
        name="dia_stream_probe", route="cuda", source="stormx_torch/csrc/probes.cu",
        replaces="scripts/perf_pallas_bisect.py:36",
        tpu_source="scripts/perf_pallas_bisect.py:kernel", shape=dict(rows=n, mode="full"),
        ok=True, max_abs_err=p2["full"]["max_abs_err"], max_err=p2["full"]["max_abs_err"],
        ms=p2["full"]["ms"], ms_l2_flushed=p2["full"]["ms_l2_flushed"],
        plain_ms=p2["full"]["plain_ms"], library_ms=None, library_call=None,
        bound_ms=p2["full"]["bound_ms"], bound_by=p2["full"]["bound_by"]))
    probe_launches = dict(probes.launches)
    emit("packed_kernel_check", operators=rows, lane_gather=p1, dia_stream_probe=p2,
         k2a=dict(rows=n, ms=k2a["ms"], ms_l2_flushed=k2a["ms_l2_flushed"],
                  gb_per_s=k2a_bytes / k2a["ms"] / 1e6,
                  gb_per_s_l2_flushed=k2a_bytes / k2a["ms_l2_flushed"] / 1e6),
         launches=probe_launches)
    main_launches = {"packed_spmv/matmul": 0, "packed_spmv/gather": 0,
                     "lane_gather": probe_launches["lane_gather"],
                     "dia_stream_probe": probe_launches["dia_stream_probe"]}

    # -- 12. Milestone A through the packed operator --------------------------
    b, jac, opts = ctx["b"], ctx["jac"], ctx["poisson_options"]
    perm, n_cells = ctx["perm"], ctx["b"].shape[0]
    it_k1 = ctx["poisson_iterations"]
    profile_options = SolverOptions(num_iterations=PROFILE_ITERATIONS, absolute_tolerance=0.0,
                                    relative_tolerance=0.0)
    runs, failures = [], []
    for variant in k4.VARIANTS:
        packed = packed_ops[("laplacian", variant)]
        reset()
        k1_before = sell_spmv.launches
        res, ms = _cuda_ms(torch, lambda: solve(make_operator(packed.matvec), b, method="cg",
                                                precond=jac, options=opts))
        launches, k1_delta = k4.launches[variant], sell_spmv.launches - k1_before
        main_launches[f"packed_spmv/{variant}"] += launches
        xv = np.empty(n_cells)
        xv[perm] = res.x.double().cpu().numpy()
        true_res = ctx["true_residual"](xv)
        run = dict(variant=variant, iterations=res.num_iterations, converged=res.converged,
                   ms=ms, ms_per_iteration=ms / max(res.num_iterations, 1),
                   k1_ms_per_iteration=ctx["poisson_ms_per_iteration"], k1_iterations=it_k1,
                   relative_error=float(res.relative_error), true_relative_residual=true_res,
                   launches=launches, k1_launches=k1_delta)
        if not res.converged:
            failures.append(f"{variant}: CG did not converge")
        if abs(res.num_iterations - it_k1) > PACKED_ITERATION_GAP * it_k1:
            failures.append(f"{variant}: {res.num_iterations} iterations vs {it_k1} with K1")
        if true_res > POISSON_TRUE_RES:
            failures.append(f"{variant}: true residual {true_res} > {POISSON_TRUE_RES}")
        if launches == 0 or k1_delta != 0:
            failures.append(f"{variant}: {launches} K4 launches, {k1_delta} K1 launches")
        # Where the time per iteration goes, as phase 5's profile of K1 CG;
        # "direct" calls the wrapper without the autograd.Function.
        run["profile"] = profile_cg(torch, lambda: cg(
            make_operator(packed.matvec), b, torch.zeros_like(b), precond=jac,
            options=profile_options))
        if variant == "matmul":
            run["profile_direct"] = profile_cg(torch, lambda: cg(
                make_operator(lambda u: k4.packed_spmv(packed, u)), b, torch.zeros_like(b),
                precond=jac, options=profile_options))
        runs.append(run)
        del res
    emit("packed_poisson", cells=n_cells, block_rows=PACKED_BLOCK_ROWS,
         relative_tolerance=POISSON_RTOL, runs=runs, failures=failures)
    require(not failures, "; ".join(failures))

    # -- 13. Newton and JFNK on 0.01·L·u + atan(u) ------------------------------
    # b and the float64 witness come from the CSR Laplacian in the original
    # cell order, on the CPU: nothing of them passes through K4a, so a K4a
    # that is wrong moves the float32 solution away from them.
    lap = packed_ops[("laplacian", "matmul")]  # K4a
    L64 = ctx["laplacian"].to_csr()
    perm_t = torch.as_tensor(perm)

    def F(u):
        return 0.01 * lap.matvec(u) + torch.atan(u)

    def F64(u):
        return 0.01 * L64.matvec(u) + torch.atan(u)

    def original(u):
        """A vector of the packed operator's (ordered) numbering in the
        original cell order, in float64 on the CPU."""
        out = torch.empty(n_cells, dtype=f64)
        out[perm_t] = u.double().cpu()
        return out

    x_true64 = original(torch.as_tensor(0.2 * np.random.default_rng(0).standard_normal(n_cells)))
    b64 = F64(x_true64)
    bn = b64[perm_t].to(dtype=f32, device=dev)
    x_true = x_true64[perm_t].to(dtype=f32, device=dev)
    inner = SolverOptions(**NEWTON_INNER)

    def newton_inner(J, r, t0):
        return bicgstab(J, r, t0, options=inner)

    def nl_options(dtype, iterations=NONLINEAR_MAX_ITERATIONS):
        return SolverOptions(num_iterations=iterations, absolute_tolerance=0.0,
                             relative_tolerance=NONLINEAR_RTOL[str(dtype).split(".")[-1]])

    def summary(res, ms, x_ref):
        rel = (res.history[: res.num_iterations + 1] / res.history[0]).double().cpu().numpy()
        return dict(iterations=res.num_iterations, converged=res.converged, ms=ms,
                    relative_residual=_finite(rel[-1]),
                    best_relative_residual=_finite(np.nanmin(np.where(np.isfinite(rel), rel,
                                                                      np.nan))),
                    max_abs_gap_to_x_true=_finite((res.x - x_ref).abs().max()))

    # The float64 runs first, on the CPU: their solutions are the witnesses.
    x20_64 = torch.full_like(x_true64, NONLINEAR_X0)
    x0s = {"newton_armijo": NONLINEAR_X0, "jfnk_ew_from_0": 0.0}
    float64, x64, failures = {}, {}, []
    for label, run in {
        "newton_armijo": lambda: newton(F64, b64, x20_64, options=nl_options(f64),
                                        line_search="armijo", inner_solve=newton_inner),
        "jfnk_ew_from_0": lambda: jfnk(F64, b64, torch.zeros_like(x20_64),
                                       options=nl_options(f64), forcing="ew"),
    }.items():
        t0 = time.perf_counter()
        res = run()
        ms = (time.perf_counter() - t0) * 1e3
        float64[label] = summary(res, ms, x_true64)
        x64[label] = res.x
        if not res.converged:
            failures.append(f"{label} does not converge in float64: {float64[label]}")
        del res

    x20 = torch.full((n_cells,), NONLINEAR_X0, dtype=f32, device=dev)
    gated = {
        "newton_armijo": lambda: newton(F, bn, x20, options=nl_options(f32),
                                        line_search="armijo", inner_solve=newton_inner),
        "jfnk_ew_from_0": lambda: jfnk(F, bn, torch.zeros_like(x20), options=nl_options(f32),
                                       forcing="ew"),
    }
    diverging = {
        "newton_undamped": lambda: newton(F, bn, x20, inner_solve=newton_inner,
                                          options=nl_options(f32, NONLINEAR_DIVERGING_ITERATIONS)),
        "jfnk_ew_from_20": lambda: jfnk(F, bn, x20, forcing="ew",
                                        options=nl_options(f32, NONLINEAR_DIVERGING_ITERATIONS)),
    }
    results = {}
    for label, run in {**gated, **diverging}.items():
        reset()
        res, ms = _cuda_ms(torch, run)
        results[label] = r = summary(res, ms, x_true)
        r["k4a_launches"] = k4.launches["matmul"]
        if label in gated:
            main_launches["packed_spmv/matmul"] += k4.launches["matmul"]
            # The float32 solution held to the CSR in float64: its relative
            # residual and its gap to the float64 run's solution.
            x32 = original(res.x)
            r0 = F64(torch.full_like(x32, x0s[label])) - b64
            r["csr_f64_relative_residual"] = _finite((F64(x32) - b64).norm() / r0.norm())
            r["max_abs_gap_to_f64"] = _finite((x32 - x64[label]).abs().max())
            if not (r["converged"] and r["csr_f64_relative_residual"] is not None
                    and r["csr_f64_relative_residual"] <= NONLINEAR_F32_RES
                    and r["max_abs_gap_to_f64"] is not None
                    and r["max_abs_gap_to_f64"] <= NONLINEAR_F32_GAP):
                failures.append(f"{label}: {r}")
        del res
    emit("nonlinear", cells=n_cells,
         operator=f"0.01·L·u + atan(u), L packed (K4a, R={lap.block_rows})",
         x0=NONLINEAR_X0, newton_inner=NEWTON_INNER, rtol=NONLINEAR_RTOL,
         gates=dict(csr_f64_relative_residual=NONLINEAR_F32_RES,
                    max_abs_gap_to_f64=NONLINEAR_F32_GAP),
         float32=results, float64_cpu_csr=float64, failures=failures)
    require(not failures, "; ".join(failures))

    for e in kernels:
        e["launches"] = main_launches[e["name"]]
        e["kernel_ms"] = e["ms"]
        require(e["launches"] > 0, f"{e['name']} was not launched on its path")
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "stormx_torch")):
        print("chip_smoke: run it from a checkout (stormx_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = run_smoke(torch, dev, GRID_SIDE)
    banded = run_banded(torch, dev, NX, FVM_SIDE)
    k2a = next(e for e in banded if e["name"] == "dia_spmv")
    kernels = out["kernels"] + banded + run_packed(torch, dev, out["packed_ctx"], k2a)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(out["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
