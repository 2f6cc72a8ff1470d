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

The FVM path follows (``run_fvm``), on phase 2's mesh unless a phase says
otherwise:

14. ``fvm_kernel_check``: K3 at every (plan, nv, dtype) the path gathers —
    float32 and float64 at nv = 2, 5, 10 on the triangles, float32 at nv =
    3, 5, 15 on a 303,918-cell ``structured_tet_box`` (``TET_SIDE``), and
    float32 at nv = 1, 2 on the projection's mesh — each bit-exact against
    its plain version and ``index_select``, one CUDA kernel per call, timed
    as phase 3 times K3; K3 on a transposed field through the plan; K1 on
    the convection–diffusion operator against its plain version.
15. ``euler``: ``FvSolver`` (order 2, Lax–Friedrichs, cubic limiters) in
    float32 with slip walls, from a Riemann state at rest, 200 steps at CFL
    0.2 (11 K3 launches a step), then 50 at order 1 (3 a step), a profile of
    10 steps, the first 5 steps against the port's float64 run on the CPU,
    and 20 steps on the tetrahedral box.
16. ``euler_implicit``: one ``implicit_step`` (JFNK) in float64 with K3's
    plans at CFL 1, held to the JAX package's residual gate.
17. ``convdiff``: BASELINE config #2 assembled, through ``auto_operator``
    (K1): the smoke's own float64 iterative refinement around capped
    float32 BiCGStab + Jacobi solves, gated on the true residual 1e-5.
18. ``laplace2d``: N = 200, 1000 sweeps in float64, held to the golden.
19. ``ns_projection``: one ``NsProjection.step`` (CG) in float32 on a
    320,000-cell ``structured_tri_rect`` (``NS_SIDE``), held to the
    divergence it removes and to the port's float64 step on the CPU.

The preconditioners and least squares follow (``run_precond``, ``run_lsq``),
on phase 2's mesh, float32 on the card; every case is held to the same case
in float64 through the plain operator on the card (iterations within 10%
+ 2, wider where ``PRECOND_ITERATION_GAP`` says why), on convergence and on
its float64 true residual:

20. ``precond``: on the implicit diffusion step V + τ·L (τ = 0.1, V the
    cell volumes, L Milestone A's Laplacian; an SPD M-matrix) through K1
    (checked against its plain version first): CG + Jacobi, CG +
    ``AmgPreconditioner`` (its fine level through K1, 3 launches per
    V-cycle), CG + ``ChebyshevPreconditioner`` (degree 4, λmax by power
    iteration through K1), CG + IC(0) and CG + AINV, CG + block-Jacobi
    through ``bsr_from_csr`` at b = 2 and 3, FGMRES + an 8-iteration CG
    inner solve; CG + SGS on the CH operator; IC(0) and SGS in sweeps mode,
    each with one exact level-scheduled solve timed and checked; FGMRES +
    ILU(0) and + SPAI(0) on the convection–diffusion operator.  IC(0) and
    AINV break down on the CH operator (non-positive pivots, in the JAX
    package too); the phase records IC(0)'s.  Milestone A's singular
    Laplacian is not used: float32 CG + AMG diverges on it
    (``scripts/torch_precond_study.py``).
21. ``lsq``: LSQR and LSMR, plain and with ``IqrPreconditioner`` (sweeps
    mode), ``LSQ_BUDGET`` iterations on the face-difference matrix of the
    mesh (478,401 × 318,402; b = A·x_true + noise, seed 0), A and Aᵀ as two
    CSRs on the card; gated on ‖Aᵀr‖/‖Aᵀb‖, on the gap to the float64 run,
    and on IQR's error against the least-squares solution (CG + AMG on AᵀA
    in float64) being below the plain run's.

Complex dtypes and the CH app's side channels close the run (``run_complex``,
``run_io``):

22. ``complex``: on the projection's 320,000-cell ``structured_tri_rect``
    (equal cell volumes, so Δ = ``div_grad`` is symmetric), with K3's plans
    on a float64 and a float32 mesh: K3 on complex64 and complex128 fields
    on the three plans ``div_grad`` reads (bit-exact, one CUDA kernel a
    call, timed warm and flushed beside ``index_select``); then CG on A_h =
    I − τΔ, every other method on A_g = (1 + iκ)I − τΔ (Richardson with ω =
    2/(2 + τ·λmax)) and LSQR/LSMR on (A_g, A_gᴴ), at complex128 (each held
    to ``COMPLEX_TRUE_RES`` × its tolerance, its true residual recomputed
    through plain gathers) and complex64 (held to its complex128 run:
    iterations and solution gap), with K3 launches counted per (nv, dtype).
23. ``io``: on phase 2's mesh, float32: ``run(..., assembled=True,
    output_every=5, checkpointer=Checkpointer(every=5))`` for 10 steps, a
    resume from its step-5 checkpoint (bit-equal), the snapshot's header
    counts and values, one step twice (``assert_deterministic``), one
    snapshot and one checkpoint save and load timed, ``main`` on the mesh's
    TetGen files from inside a temporary directory for ``MAIN_STEPS``
    steps (a snapshot a step), a
    ``trace`` whose ``annotate`` region around two steps holds K1 and K3,
    ``checked`` on an out-of-range gather on the card (the next kernel
    still runs), and ``segment_sum`` deterministic over 1,048,576 entries.

The distributed layer (``run_parallel``, ``run_parallel_banded``) closes the
run.  P = 1 runs under NCCL (a world of one rank, so its all-reduces are NCCL
launches on the card); P = 4 runs as four rank processes
(``stormx_torch.parallel.comm.RankPool``, started once for both phases) that share
the card over gloo, which stages every collective through the host (NCCL
takes one rank per card, and ranks as threads of one process serialize
their launches on its CUDA context):

24. ``parallel``: on phase 2's mesh, V + τ·L of phase 20 in float32, b from
    ``default_rng(0)``: K1 on a slab operator (rank 1 of 4's extended slab,
    ``pad_lo = 0``, and a block range of it) against its plain version
    (within 1e-5·max|y|), timed beside cuSPARSE; ``sharded_matvec`` against
    the float64 serial product; then at P = 1 and 4: ``sharded_solve`` CG +
    ``precond_diag`` on ``partition_csr`` by ``"rcm-blocks"`` and
    ``"bfs"``, ``sharded_sliced_solve`` CG + Jacobi in mode ``"pallas"``
    (K1 on every slab product, three launches a product, counted exactly),
    CG + ``DistributedAmg`` (its coarse V-cycle's first level through K1),
    CG + Chebyshev (degree 4, Gershgorin's λmax) and FGMRES + Krylov (CG 8);
    the ``"dense"`` mode once at P = 1 when its windows fit
    ``PAR_DENSE_BYTES``; BiCGStab + ``ras="ilu0"`` on a ``PAR_RAS_SIDE``²
    mesh of the same kind (its iterations grow with P by design); float64
    CG + Jacobi at both P, equal iterations and histories within
    ``PAR_F64_HISTORY``.  Every rank's iterations agree, every float32
    solve's float64 true residual is under phase 20's gate and its
    iterations at P = 1 and 4 within 2%.  It prints ms per solve and per
    iteration, collectives and K1 launches per rank per iteration, and the
    host partition seconds.
25. ``parallel_banded``: ``sharded_dia_solve`` CG on phase 7's 2048²
    operator at P = 1 and 4, held to phase 8's serial CG (iterations within
    2%, the true residual under phase 8's gate), with ms per iteration and
    the bytes shifted per link.

The launch counters are set to 0 just before each of phases 4, 5, 8–10,
11–13, 15–19, 20–21, 22's solves, 23 and 24's solves and read just after; K1
and K3 must have run in the app phase, K1 in the Poisson phase, K2a in
phases 8–10, K2a with its dot product and K2b in phase 8, P1 and P2 in phase
11, K4a and K4b in phases 12–13, K3 at every case of phase 14, K1 in phases
15–19 and in phase 20, K3 on complex64 and complex128 fields in phase 22, K1
and K3 in phase 23, K1 on every slab product of phase 24's sliced solves.
Then come the
``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
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
# The kernels of the Cahn–Hilliard path; the cell-adjacency plan serves
# gradients and limiters, which that app does not run, so it is checked only
# there; the FVM phases (14-19) check and count it at their shapes.
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

# The FVM path (phases 14-19), on phase 2's mesh.  K3's cases: every (plan,
# nv) the path gathers, in float32 (explicit march) and float64 (implicit
# step) on the triangles, in float32 on a tetrahedral box, and in float32 on
# the projection's structured mesh.  nv: 1 the projection's scalars, 2/3
# cell and face centres and velocities, 5 the conserved state and face
# fluxes, 10/15 the state's gradients.
FVM_CASES = {"cell_adj": (2, 5), "cell_face": (2, 5), "face_inner": (2, 5, 10),
             "face_outer": (2, 5, 10)}
FVM_CASES_3D = {"cell_adj": (3, 5), "cell_face": (3, 5), "face_inner": (3, 5, 15),
                "face_outer": (3, 5, 15)}
NS_CASES = {"cell_adj": (1, 2), "cell_face": (1,), "face_inner": (1, 2), "face_outer": (1, 2)}
# structured_tet_box(37, 37, 37): 303,918 tetrahedra.  Its cell←face,
# face_outer and cell_adj maps are wider than MAX_CHUNKS = 64 windows of 128
# (`scripts/torch_fvm_study.py tetplans 16 32 34 37`): the JAX plan gathers
# such a map plainly, and K3 takes it with its indices as the words, so a
# 3-D step launches K3 eleven times too.
TET_SIDE = 37
EULER_CFL = 0.2
EULER_STEPS = 200
EULER_ORDER1_STEPS = 50
EULER_3D_STEPS = 20
EULER_PROFILE_STEPS = 10
EULER_CPU_STEPS = 5
K3_PER_STEP = {1: 3, 2: 11}  # gathers of a step, all through K3
# Σ ρ·V and Σ ρE·V, summed in float64.  The slip wall removes the normal
# velocity of the ghost state (SkunkFvBC.hpp:122-141), so its Lax–Friedrichs
# mass flux is ½ρvₙ, not 0: the walls the Riemann state's flow runs along
# leak mass and energy at the dissipation level, in float64 as in float32
# (200 steps of this march: 2.1e-5 and 3.0e-5 of mass and energy at side
# 55, 1.5e-5 and 2.1e-5 at side 110, float64 on the CPU; float32 within
# 2e-8 of that: `scripts/torch_fvm_study.py leak 55`).  So the march's drift is gated at EULER_LEAK, and the card's
# float32 change over the first EULER_CPU_STEPS steps must equal the float64
# CPU run's change to float32 rounding: each step rounds every cell's update
# to float32 (≤ ε₃₂/2 relative), n·ε₃₂ relative after n steps at worst.
EULER_LEAK = 1e-4
EULER_ROUNDING = EULER_CPU_STEPS * float(np.finfo(np.float32).eps)
# 5 float32 steps on the card against float64 on the CPU, of max|u|: the
# limiters' branches can flip on rounding (1.4e-6 on an H100 80GB HBM3).
EULER_CPU_GAP = 1e-4
# The implicit step's dt: CFL 1 on the smallest cell (dt = 1.24e-5 × 5 on
# this mesh).  The JAX package's slow test takes dt = 5e-4 on the 79,672-cell
# step mesh; on this mesh that is CFL ~8.  JFNK has no line search, and the
# limiters make f(û) non-smooth: at CFL 3 (side 200, float64 on the CPU) its
# residual cycles between 4.7e-3 and 6.4e-3 for all 30 iterations, while at
# CFL 1 it converges in 9 iterations and 57 operator applications
# (`scripts/torch_fvm_study.py implicit 200 3`, `... 200 1`); at dt = 5e-4 on
# this mesh one step did not end within 1,000 s on an H100.
IMPLICIT_CFL = 1.0
IMPLICIT_RES = 1e-9  # ‖û + dt·f(û) − u⁰‖ ≤ 1e-9·‖u⁰‖, the JAX gate
CONVDIFF_EPS = 0.05  # tests/test_baseline_configs.py's EPS_DIFF
CONVDIFF_RTOL = 1e-5
# BiCGStab + Jacobi in float32 breaks down on this operator at scale: on the
# jittered Delaunay mesh its residual first grows ~5e4-fold, and its float32
# iterate then carries that much rounding.  At side 220 (96k cells, on the
# CPU, `scripts/torch_fvm_study.py convdiff 220`) it reports 1e-5 after 1,907
# iterations at a true residual of 18; in float64 the hump is 297-fold and
# the same run reaches a true residual of 3e-6.  So the smoke refines in
# float64 around capped float32 BiCGStab solves through K1 (side 220: 12
# outer steps of 200 iterations to a true residual of 9.4e-7), and gates that.
CONVDIFF_INNER_RTOL = 1e-2
CONVDIFF_INNER_CAP = 200
CONVDIFF_OUTER_CAP = 40
LAPLACE_N = 200
LAPLACE_SWEEPS = 1000
LAPLACE_GOLDEN = 0.0121789  # BitternLaplace2D.cpp:403-422 (tests/test_laplace2d.py)
# The projection runs on structured_tri_rect(NS_SIDE, NS_SIDE), 320,000
# cells of equal area: its pressure operator, the volume-weighted div-grad,
# is symmetric only where volumes are equal, and its right-hand side is made
# mean-free, not volume-weighted-mean-free, so it is consistent only there.
# On the jittered Delaunay mesh CG diverges on it, in float64 as in float32
# (side 55 on the CPU: 20,000 iterations, divergence ratio 1.3e19 and 7.5e6;
# `scripts/torch_fvm_study.py projection 55`); the JAX package's projection
# tests run on structured meshes too.
NS_SIDE = 400
NS_DT = 1e-2
NS_OPTIONS = dict(num_iterations=5_000, absolute_tolerance=0.0, relative_tolerance=1e-4)
# ‖corrected face-flux divergence − its mean‖₂ over the initial ‖div‖₂,
# summed in float64.  It equals dt·‖r − mean‖₂/‖div‖₂, r the pressure
# solve's true residual, since the correction is the Poisson operator's own
# stencil.  In float64 (CG to 1e-8) it is 3.6e-8.  In float32 it is set by
# CG, which stops on its recurrence residual (1e-4) while its true residual
# is 1.5e-2: 5.79e-2, and 7.08e-2 (true residual 1.9e-2) for the JAX
# package's own float32 step, on the CPU (`tests/test_torch_ns_float32.py
# 400`).  Rounding the float64 step's face fluxes to float32 gives only
# 7.1e-6, its pressure 1.6e-3.  So the float32 gate sits above the
# reference's own floor, and NS_IDENTITY holds the card's corrected fluxes to
# the true residual of its own pressure, recomputed in float64 on the CPU
# (1.4e-5 apart at side 100 on the CPU: `tests/test_torch_ns_float32.py 100`).
NS_DIV_FRACTION = {"float32": 0.1, "float64": 1e-6}
NS_IDENTITY = 1e-2
# ‖x32 − x64‖₂/‖x64‖₂ of velocity, pressure and face fluxes against the
# float64 CPU step: 1.6e-4, 3.1e-5 and 2.8e-4 on an H100 80GB HBM3 (700 W).
NS_CPU_GAP = 2e-3

# The preconditioners and least squares (phases 20-21), on phase 2's mesh, in
# the kernel operators' numbering: the implicit diffusion step V + τ·L built
# from Milestone A's Laplacian (an SPD M-matrix: Jacobi, AMG, Chebyshev,
# IC(0), AINV, block-Jacobi, Krylov), the CH operator of phase 4 (SGS; IC(0)
# and AINV break down on it), the convection-diffusion operator of phase 17
# (nonsymmetric: ILU(0) and SPAI(0) under FGMRES).  Milestone A's singular
# Laplacian itself is left out: float32 CG + AMG diverges on it, float32
# products of its smooth modes being too inexact, while float64 CG + AMG
# takes 117 iterations (scripts/torch_precond_study.py).  Each float32 case
# on the card is held to the same case in float64 through the plain operator
# on the card.
PRECOND_RTOL = {"diffusion": 1e-5, "ch": 1e-4, "convdiff": 1e-4}
# float32 true residuals, gated where float32 floors on each operator (the
# float64 runs reach the tolerance): CG + Jacobi on the diffusion step
# 4.2e-4, CG + SGS on the CH operator 1.9e-2 (4,192 iterations), FGMRES +
# ILU(0) or SPAI(0) on convection-diffusion 1.6e-3 (H100 80GB HBM3, 700 W).
PRECOND_TRUE_RES = {"diffusion": 1e-3, "ch": 5e-2, "convdiff": 1e-2}
DIFFUSION_TAU = 1e-2  # V + τ·L: an implicit diffusion step of length τ
# SPAI(0) and AINV run on the same jittered grid at 200×200 (79,202 cells, the
# reference's step-mesh scale): at full size their host builds took 21 and
# 16 s and SPAI's float32 FGMRES 5,196 iterations, 33 s (H100 80GB HBM3,
# 700 W), which would take the two phases past ~120 s.
PRECOND_SMALL_SIDE = 200
PRECOND_MAX_ITERATIONS = 10_000
# Iterations within 10% (+2) of the float64 run's; wider where the iteration
# itself amplifies roundoff, in the JAX package too: Chebyshev's 10 power
# iterations underestimate λmax, so p(A) is negative on the top of the
# spectrum and CG runs with an indefinite preconditioner (tests/
# test_torch_precond.py; 171 against 152 in a CPU rehearsal at 19,602
# cells); the Krylov preconditioner is nonlinear in r, and FGMRES restarts
# every 50 (67 against 90 there); float32 FGMRES on convection-diffusion
# needs 1.7× (ILU(0), with either orthogonalization) and 2.2× (SPAI(0)) the
# float64 iterations (scripts/torch_precond_study.py).
PRECOND_ITERATION_GAP = {"chebyshev": 0.25, "krylov": 0.5, "ilu0": 1.5, "spai0": 1.5}
PRECOND_ITERATION_GAP_DEFAULT = 0.1
PRECOND_AMG_SWEEPS = 1
PRECOND_CHEB_DEGREE = 4
PRECOND_TRI_SWEEPS = 3  # Jacobi sweeps of each triangular solve
PRECOND_TRI_EXACT_RES = 1e-5  # ‖T·y − r‖/‖r‖ of one exact (level-scheduled) solve
PRECOND_BLOCK_SIZES = (2, 3)
PRECOND_KRYLOV_INNER = 8
# LSQR/LSMR on the face-difference matrix (478,401 × 318,402): b = A·x_true +
# LSQ_NOISE·N(0, 1) from seed 0, a fixed budget of iterations.
LSQ_NOISE = 1e-2
LSQ_BUDGET = 300
LSQ_SWEEPS = 3
LSQ_NORMAL_RES = {"plain": 1e-2, "iqr": 1e-3}
LSQ_F64_GAP = 1e-2
# The complex solves (phase 22), on the projection's structured_tri_rect(400,
# 400) (equal cell volumes, so Δ = div_grad is symmetric): A_h = I − τΔ
# (Hermitian) for CG, A_g = (1 + iκ)I − τΔ for the general methods, A_gᴴ =
# (1 − iκ)I − τΔ beside it for LSQR/LSMR.  τ = 3e-3·(100/400)²: at τ·λmax(−Δ)
# ≈ 682 (Gershgorin) CG takes 233 iterations to 1e-8 on the CPU at side 100
# with τ = 3e-3, and τ·λmax is the same at side 400.  Richardson's ω =
# 2/(2 + τ·λmax), λmax from Gershgorin's bound on the host.
COMPLEX_TAU = 3e-3 * (100 / NS_SIDE) ** 2
COMPLEX_KAPPA = 0.5
COMPLEX_METHODS = ("cg", "cgs", "bicgstab", "bicgstab_l", "tfqmr", "tfqmr1", "idrs", "gmres",
                   "fgmres", "lgmres", "richardson", "lsqr", "lsmr")
COMPLEX_RTOL = {"complex128": 1e-8, "complex64": 1e-5}
# LSQR/LSMR converge as CG on the normal equations (cond²): 4,918 and 5,022
# iterations to 1e-8 on an H100 80GB HBM3 at 700 W, 23.5 s of the phase's 57
# (first run of the phase), so they stop 100× earlier.
COMPLEX_LSQ_RTOL = {"complex128": 1e-6, "complex64": 1e-4}
COMPLEX_CAP = {"richardson": 20_000, "lsqr": 20_000, "lsmr": 20_000}
COMPLEX_CAP_DEFAULT = 3_000
COMPLEX_TRUE_RES = 1.1  # × the complex128 tolerance, recomputed through the plain gathers
# complex64 against complex128: iterations against the complex128 run's first
# entry under the complex64 tolerance (CPU rehearsals: within 4% at side 100,
# BiCGStab +14% at side 30, whose residual is not monotone and crosses the
# tolerance at another step under other rounding), solution gap relative to
# the complex128 solution, as a multiple of the complex64 tolerance (≤ 22×
# in both rehearsals and on the card's first run of the phase).
COMPLEX64_ITERATION_GAP = 0.25
COMPLEX64_SOLUTION_GAP = 100
# The io phase (23), on the CH main path (phase 2's mesh, float32).
IO_STEPS = 10
IO_EVERY = 5
# main's steps: a CH step costs ~3 s on the 318k mesh (main took 79.0 s for
# 2 steps and 102.7 s for 10 on the H100), so phase 23 drives two (a
# snapshot each) where it drove ten, to make room for phases 24-25.
MAIN_STEPS = 2
SEGMENT_ROWS = 1_048_576
SEGMENT_COUNT = 1_024

# Phases 24-25, the distributed layer.  P = 1 runs under NCCL; P = PAR_PARTS
# ranks are processes sharing the card over gloo (NCCL takes one rank per
# card; threads would serialize their launches on one CUDA context).  Every
# float32 case is gated on its float64 true residual (phase 20's gate for
# the operator) and, at both P, on iteration counts within PAR_ITERATION_GAP of
# each other; RAS's grow with P by design.
PAR_PARTS = 4
PAR_TIMEOUT = 300.0  # seconds a collective may wait before a rank fails
PAR_ITERATION_GAP = 0.02
# FGMRES + Krylov (CG 8) in float32 takes 203 iterations at P = 1 and 302 at
# P = 4 (two card runs on the H100): its residual estimate reaches 1e-5
# within ~15% of float32's floor for it (true residuals 1.2e-5, 9.8e-6), so
# rounding decides its last restarts; phase 20 allows it 0.5 between float32
# and float64 for the same reason.
PAR_ITERATION_GAP_BY_CASE = {"krylov": 0.6}
# float64 CG + Jacobi, P = 1 against P = 4: equal iterations, histories
# within 1e-8 over the first PAR_F64_EXACT iterations (on the H100:
# 5.7e-14 at iteration 200; first past 1e-8 at 289) and within
# PAR_F64_HISTORY over all 912 (measured 3.1e-3, at its peak near iteration
# 600).  The serial float64 CG on the same operator parts from P = 1 as far
# (3.2e-3): CG's late iterations turn any change of summation order into
# gaps of that size, so the gate past PAR_F64_EXACT holds that size.
PAR_F64_EXACT = 200
PAR_F64_HISTORY = 1e-2
PAR_MATVEC = 1e-5  # sharded_matvec against the float64 serial product, × max|y|
PAR_DENSE_BYTES = 2**31  # the dense-window mode's cap (sell_from_csr's max_dense_bytes)
# RAS's apply is two exact level-scheduled solves (a launch loop per level,
# ~181 µs a level on the H100, phase 20), so it runs on a smaller mesh of
# the same kind.
PAR_RAS_SIDE = 100


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


def bracketed_kernels(names: list) -> list:
    """The kernel names that lie between two empty kernels in a trace's
    time-ordered CUDA kernel names, one list per bracketed stretch that holds
    any."""
    marks = [i for i, n in enumerate(names) if "empty_kernel" in n]
    return [names[a + 1:b] for a, b in zip(marks, marks[1:]) if b > a + 1]


def cuda_kernels_in(torch, fn, dev, attempts: int = 5, calls: int = 8) -> tuple[list, int]:
    """The names of the CUDA kernels that one call of ``fn`` launches, from
    a ``torch.profiler`` trace (after one call outside it), and the number
    of traces taken.

    One trace holds ``calls`` calls, each between two empty kernels a side,
    and only the kernels between two empty kernels count.  A profiler
    session on the H100 now and then loses records: a whole session, its
    first records, a kernel between intact brackets.  A lost record only
    ever shortens a stretch, so the call's kernels are the longest stretch
    of the trace; a trace with none is taken again, ``attempts`` times at
    most."""
    from torch.profiler import ProfilerActivity, profile

    from stormx_torch.ops import banded_gather

    fn()
    torch.cuda.synchronize()
    names = []
    for attempt in range(1, attempts + 1):
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
        stretches = bracketed_kernels(names)
        if stretches:
            return max(stretches, key=len), attempt
    require(False, f"{attempts} profiler traces of {calls} calls held no kernel between "
                   f"empty kernels (last: {names})")


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


def profile_cg(torch, solve, iterations: int = PROFILE_ITERATIONS, match: str | None = None) -> dict:
    """Device-busy share and kernel time by name over ``iterations`` CG
    iterations (or time steps), from a ``torch.profiler`` trace of ``solve``;
    with ``match``, also the device time of the kernels whose name holds it,
    per iteration and as a share of the busy time."""
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
    out = dict(
        iterations=iterations,
        wall_us_per_iteration=wall_us / iterations,
        device_busy_us_per_iteration=busy_us / iterations,
        device_busy_share=busy_us / wall_us if busy_us else None,
        kernels_per_iteration=sum(v[0] for v in by_name.values()) / iterations,
        top=[dict(name=n, count=c, us=t) for n, (c, t) in top],
    )
    if match is not None:
        hit = [v for n, v in by_name.items() if match in n]
        hit_us = sum(v[1] for v in hit)
        out["matched"] = dict(name=match, count_per_iteration=sum(v[0] for v in hit) / iterations,
                              us_per_iteration=hit_us / iterations,
                              share_of_busy=hit_us / busy_us if busy_us else None)
    return out


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
                                banded_gather.empty_launch(p.word_starts.numel(), dev))
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
        p.launches_by_shape.clear()
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
    # What the packed phases (11-13) and the FVM phases (14-19) take over from
    # phases 2, 3 and 5.
    packed_ctx = dict(mesh=mesh, points=pts, tris=tris, ch_op=op, laplacian_op=lop, laplacian=L,
                      perm=perm, b=b, jac=jac,
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


def run_banded(torch, dev, nx: int, fvm_side: int, ctx: dict | None = None) -> list:
    """Phases 7-10, the banded path.  Returns the K2 entries of the
    ``kernels`` line, with their launches on the path; ``ctx`` (when given)
    receives phase 8's serial CG under ``"banded_cg"``."""
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
    if ctx is not None:
        ctx["banded_cg"] = dict(iterations=it_a, ms_per_iteration=ms_a / max(it_a, 1),
                                true_relative_residual=tr_a)
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


def riemann_state(torch, centers, dtype, dev):
    """The Sod-type Riemann state at rest: (ρ, p) = (1, 1) for x < 0.5, else
    (0.125, 0.1), as conserved variables."""
    from stormx_torch.fvm import state_from_prim

    left = centers[:, 0] < 0.5
    prim = np.zeros((len(centers), 5))
    prim[:, 0] = np.where(left, 1.0, 0.125)
    prim[:, 1] = np.where(left, 1.0, 0.1)
    prim = torch.as_tensor(prim, dtype=dtype, device=dev)
    return state_from_prim(torch.zeros((len(centers), 3), dtype=dtype, device=dev),
                           prim).make_cons()


def smooth_state(torch, centers, dtype, dev):
    """The smooth state of tests/test_baseline_configs.py:201-211."""
    from stormx_torch.fvm import state_from_prim

    c = centers
    rho = 1.0 + 0.2 * np.sin(2 * np.pi * c[:, 0]) * np.sin(np.pi * c[:, 1])
    p = 1.0 + 0.1 * np.cos(np.pi * c[:, 0])
    vx = 0.5 + 0.1 * np.sin(np.pi * c[:, 1])
    vy = 0.05 * np.cos(2 * np.pi * c[:, 0])
    prim = np.stack([rho, p, vx, vy, np.zeros_like(vx)], axis=1)
    n = np.tile([1.0, 0.0, 0.0], (len(c), 1))
    return state_from_prim(torch.as_tensor(n, dtype=dtype, device=dev),
                           torch.as_tensor(prim, dtype=dtype, device=dev)).make_cons()


def taylor_green(centers):
    """tests/test_navier_stokes.py:18-33: the Taylor–Green field plus a
    removable gradient pollution."""
    x, y = centers[:, 0], centers[:, 1]
    u = np.sin(np.pi * x) * np.cos(np.pi * y)
    v = -np.cos(np.pi * x) * np.sin(np.pi * y)
    gx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    gy = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return np.stack([u + gx, v + gy], axis=1)


def rotating_velocity(r):
    """tests/test_baseline_configs.py's convection field."""
    c = r - 0.5
    return np.stack([-c[:, 1] - 0.4, c[:, 0] + 0.8], axis=1)


def cfl_dt(mesh, speed: float) -> float:
    """EULER_CFL times the smallest cell's V / Σ face areas over ``speed``."""
    per_cell = np.zeros(mesh.num_cells)
    np.add.at(per_cell, mesh.face_cells[:, 0], mesh.face_areas)
    outer = mesh.face_cells[:, 1]
    np.add.at(per_cell, outer[outer >= 0], mesh.face_areas[outer >= 0])
    return EULER_CFL * float((mesh.cell_volumes / per_cell).min()) / speed


def gas_totals(torch, dmesh, u) -> tuple[float, float]:
    """Σ ρ·V and Σ ρE·V, summed in float64."""
    vol = dmesh.cell_volumes.double()
    return float((u[:, 0].double() * vol).sum()), float((u[:, 1].double() * vol).sum())


def k3_case(torch, plan, x, idx, flush, dev) -> dict:
    """K3 on one (plan, nv, dtype): bit-exact against its plain version and
    ``index_select``, one CUDA kernel per call, and its times."""
    from stormx_torch.ops import banded_gather

    g_k = banded_gather.banded_gather_cuda(plan, x)
    g_p = banded_gather.banded_gather_plain(plan, x)
    g_l = torch.index_select(x, 0, idx)
    torch.cuda.synchronize()
    require(torch.equal(g_k, g_p), "K3 differs from its plain version")
    require(torch.equal(g_k, g_l), "K3 differs from x[idx]")
    per_call, traces = cuda_kernels_in(torch, lambda: banded_gather.banded_gather_cuda(plan, x),
                                       dev)
    require(len(per_call) == 1, f"K3 launched {per_call} in one call, not one kernel")
    row = x[0].numel() * x.element_size()
    b_ms, b_by = bound_ms(4.0 * plan.m + row * (plan.m + plan.n_src), 0.0)
    return dict(
        ok=True, max_abs_err=0.0, max_err=0.0, cuda_kernels_per_call=1, profiler_traces=traces,
        ms=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, x)),
        ms_l2_flushed=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, x),
                              flush=flush),
        plain_ms=time_ms(torch, lambda: banded_gather.banded_gather_plain(plan, x)),
        library_ms=time_ms(torch, lambda: torch.index_select(x, 0, idx)),
        library_call="torch.index_select(x, 0, idx)",
        bound_ms=b_ms, bound_by=b_by,
    )


def plan_index(mesh, dmesh, name):
    """The index map of a mesh's K3 plan, as NumPy."""
    return {"face_inner": mesh.face_cells[:, 0],
            "face_outer": np.where(mesh.face_cells[:, 1] >= 0, mesh.face_cells[:, 1],
                                   mesh.face_cells[:, 0]),
            "cell_face": dmesh.cell_face_ell.reshape(-1).cpu().numpy(),
            "cell_adj": dmesh.cell_adj_ell.reshape(-1).cpu().numpy()}[name]


def run_fvm(torch, dev, ctx: dict, tet_side: int = TET_SIDE, ns_side: int = NS_SIDE) -> list:
    """Phases 14-19, the FVM path on phase 2's mesh.  Returns the K3 entries
    of its (plan, nv, dtype) cases and K1's on the convection–diffusion
    operator, with their launches on the path."""
    from stormx_torch.apps.laplace2d import laplace2d
    from stormx_torch.apps.navier_stokes import (NsProjection, cell_divergence, face_fluxes,
                                                 flux_divergence)
    from stormx_torch.fvm import (FvSolver, assemble_convection_diffusion, slip_bc,
                                  state_from_cons)
    from stormx_torch.mesh import structured_tet_box, structured_tri_rect
    from stormx_torch.ops import banded_gather, sell_spmv
    from stormx_torch.precond import JacobiPreconditioner
    from stormx_torch.solvers import SolverOptions, bicgstab, make_operator
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import SlicedELL, auto_operator

    f32, f64 = torch.float32, torch.float64
    mesh = ctx["mesh"]
    centers = mesh.cell_centers

    # -- 14. set-up, and K3 and K1 at the path's shapes ----------------------
    t0 = time.perf_counter()
    dm32 = mesh.device_arrays(f32, device=dev, banded_gather=True)
    dm64 = mesh.device_arrays(f64, device=dev, banded_gather=True)
    setup_2d_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ns_mesh = structured_tri_rect(ns_side, ns_side).optimize_ordering()
    ctx["ns_mesh"] = ns_mesh  # phase 22's mesh too
    ns = NsProjection(ns_mesh, nu=1e-2, method="cg",
                      solver_kw={"options": SolverOptions(**NS_OPTIONS)},
                      banded_gather=True, dtype=f32, device=dev)
    tg = taylor_green(ns_mesh.cell_centers)
    vel0 = torch.as_tensor(tg, dtype=f32, device=dev)
    # Phase 19's predicted velocity, for its identity gate; taken here so that
    # its gathers stay out of the path's counts.
    v_star = ns.predictor(vel0, NS_DT).double().cpu()
    setup_ns_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmesh = structured_tet_box(tet_side, tet_side, tet_side).optimize_ordering()
    dm3 = tmesh.device_arrays(f32, device=dev, banded_gather=True)
    setup_3d_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = assemble_convection_diffusion(mesh, rotating_velocity, CONVDIFF_EPS)
    cd_csr = ell.to_csr()
    cd_op, cd_perm = auto_operator(CSR(data=cd_csr.data.to(f32), indices=cd_csr.indices,
                                       row_ptr=cd_csr.row_ptr, shape=cd_csr.shape),
                                   coords=centers, device=dev)
    setup_cd_s = time.perf_counter() - t0
    require(isinstance(cd_op, SlicedELL) and cd_op.mode == "cuda",
            "the convection-diffusion operator did not resolve to the kernel mode")
    ctx["convdiff"] = dict(csr=cd_csr, op=cd_op, perm=cd_perm)

    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=f32, device=dev)  # 128 MB > L2
    gen = torch.Generator(device="cpu").manual_seed(5)
    cases = []  # (entry, plan, (nv, dtype))
    failures = []
    groups = (("fvm", mesh, dm32, f32, FVM_CASES), ("fvm", mesh, dm64, f64, FVM_CASES),
              ("fvm3d", tmesh, dm3, f32, FVM_CASES_3D), ("ns", ns_mesh, ns.dmesh, f32, NS_CASES))
    for label, host, dm, dtype, table in groups:
        for name, nvs in table.items():
            plan = getattr(dm, "bg_" + name)
            require(plan is not None, f"the {label} {name} plan is missing")
            idx = torch.as_tensor(plan_index(host, dm, name), dtype=torch.int64, device=dev)
            for nv in nvs:
                shape = (plan.n_src,) if nv == 1 else (plan.n_src, nv)
                x = torch.randn(shape, generator=gen, dtype=dtype).to(dev)
                tag = f"banded_gather/{label}/{name}/nv{nv}/{str(dtype).split('.')[-1]}"
                try:
                    e = k3_case(torch, plan, x, idx, flush, dev)
                except RuntimeError as err:
                    failures.append(f"{tag}: {err}")
                    continue
                cases.append((dict(name=tag, route="cuda",
                                   source="stormx_torch/csrc/banded_gather.cu",
                                   replaces="stormx/ops/pallas_gather.py:40",
                                   tpu_source="stormx/ops/pallas_gather.py:_kernel",
                                   shape=dict(m=plan.m, n_src=plan.n_src, nv=nv,
                                              dtype=str(dtype).split(".")[-1],
                                              window=plan.window,
                                              fixups=int(plan.fix_pos.numel()),
                                              jax_plain_gather=plan.xla_fallback), **e),
                              plan, (nv, dtype)))
    # K3 on a transposed field, through the plan's dispatcher.
    plan = dm32.bg_face_inner
    xt = torch.randn(5, plan.n_src, generator=gen, dtype=f32).to(dev).t()
    transposed_ok = torch.equal(plan(xt), banded_gather.banded_gather_plain(plan, xt))
    if not transposed_ok:
        failures.append("K3 differs from its plain version on a transposed field")
    # K1 on the convection-diffusion operator.
    x = torch.randn(cd_op.shape[1], generator=gen, dtype=f32).to(dev)
    y_k = sell_spmv.sell_spmv_cuda(cd_op, x)
    y_p = sell_spmv.sell_spmv_plain(cd_op, x)
    torch.cuda.synchronize()
    k1_err, k1_scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    if k1_err > 1e-5 * k1_scale:
        failures.append(f"K1 on the convection-diffusion operator: {k1_err} > 1e-5·{k1_scale}")
    cd_host = sell_to_csr(cd_op)
    a_csr, nnz = torch_csr(torch, cd_host, dev), int(cd_host.nnz)
    nb, K, R = cd_op.data.shape
    b_ms, b_by = bound_ms(8.0 * nnz + 4.0 * (cd_op.shape[0] + cd_op.shape[1]), 2.0 * nnz)
    k1_entry = dict(
        name="sell_spmv/convdiff", route="cuda", source="stormx_torch/csrc/sell_spmv.cu",
        replaces="stormx/ops/pallas_sell.py:64", tpu_source="stormx/ops/pallas_sell.py:_kernel",
        shape=dict(rows=cd_op.shape[0], nnz=nnz, K=K, R=R, window=cd_op.window),
        ok=k1_err <= 1e-5 * k1_scale, max_abs_err=k1_err, max_err=k1_err, max_abs_y=k1_scale,
        ms=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(cd_op, x)),
        ms_l2_flushed=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(cd_op, x), flush=flush),
        plain_ms=time_ms(torch, lambda: sell_spmv.sell_spmv_plain(cd_op, x)),
        library_ms=time_ms(torch, lambda: a_csr @ x),
        library_call="torch.sparse_csr_tensor @ x",
        bound_ms=b_ms, bound_by=b_by,
    )
    del a_csr, flush, x, y_k, y_p
    emit("fvm_kernel_check", cells=mesh.num_cells, faces=mesh.num_faces,
         boundary_faces=int(mesh.face_label_ranges[-1] - mesh.face_label_ranges[1]),
         tet_cells=tmesh.num_cells, tet_faces=tmesh.num_faces, ns_cells=ns_mesh.num_cells,
         setup_s=dict(device_meshes=setup_2d_s, tet_box=setup_3d_s, projection=setup_ns_s,
                      convdiff_assembly=setup_cd_s),
         k3=[c[0] for c in cases], k3_transposed_bit_exact=transposed_ok, k1=k1_entry,
         failures=failures)
    require(not failures, "; ".join(failures))

    # The path: phases 15-19 with every count at 0 just before.
    plans = [getattr(g[2], "bg_" + n) for g in groups for n in FVM_CASES]
    banded_gather.launches = 0
    sell_spmv.launches = 0
    for p in plans:
        p.launches_by_shape.clear()

    # -- 15. the explicit Euler march -----------------------------------------
    failures = []
    u0 = riemann_state(torch, centers, f32, dev)
    dt = cfl_dt(mesh, float(np.sqrt(1.4)))  # max |v| + c of the state at rest
    solver = FvSolver(dm32, bcs={1: slip_bc})
    u5 = solver.march(u0, dt, EULER_CPU_STEPS)  # also the warm-up
    torch.cuda.synchronize()
    runs = {}
    for order, steps in ((2, EULER_STEPS), (1, EULER_ORDER1_STEPS)):
        s = solver if order == 2 else FvSolver(dm32, order=1, bcs={1: slip_bc})
        k3_before = banded_gather.launches
        u, ms = _cuda_ms(torch, lambda s=s, steps=steps: s.march(u0, dt, steps))
        per_step = (banded_gather.launches - k3_before) / steps
        if per_step != K3_PER_STEP[order]:
            failures.append(f"order {order}: {per_step} K3 launches per step, not "
                            f"{K3_PER_STEP[order]}")
        st = state_from_cons(torch.zeros((u.shape[0], 2), dtype=f32, device=dev), u)
        m0, e0 = gas_totals(torch, dm32, u0)
        m1, e1 = gas_totals(torch, dm32, u)
        run = dict(steps=steps, ms_per_step=ms / steps, k3_launches_per_step=per_step,
                   finite=bool(torch.isfinite(u).all()), min_rho=float(st.rho.min()),
                   min_p=float(st.p.min()), mass_drift=abs(m1 - m0) / m0,
                   energy_drift=abs(e1 - e0) / e0)
        if not (run["finite"] and run["min_rho"] > 0 and run["min_p"] > 0):
            failures.append(f"order {order}: non-finite or non-positive state: {run}")
        if max(run["mass_drift"], run["energy_drift"]) > EULER_LEAK:
            failures.append(f"order {order}: mass or energy drift {run} > {EULER_LEAK}")
        runs[f"order{order}"] = run
    prof = profile_cg(torch, lambda: solver.march(u0, dt, EULER_PROFILE_STEPS),
                      iterations=EULER_PROFILE_STEPS, match="banded_gather_kernel")
    # The first steps against the port's float64 run on the CPU (plain gathers).
    t0 = time.perf_counter()
    dm_cpu = mesh.device_arrays(f64, device="cpu", banded_gather=False)
    u5_cpu = FvSolver(dm_cpu, bcs={1: slip_bc}).march(
        riemann_state(torch, centers, f64, "cpu"), dt, EULER_CPU_STEPS)
    cpu_s = time.perf_counter() - t0
    gap = float((u5.double().cpu() - u5_cpu).abs().max() / u5_cpu.abs().max())
    if gap > EULER_CPU_GAP:
        failures.append(f"{EULER_CPU_STEPS} steps differ from the CPU float64 run by {gap}")
    totals0 = gas_totals(torch, dm_cpu, riemann_state(torch, centers, f64, "cpu"))
    change32 = [(a - b) / b for a, b in zip(gas_totals(torch, dm32, u5), totals0)]
    change64 = [(a - b) / b for a, b in zip(gas_totals(torch, dm_cpu, u5_cpu), totals0)]
    rounding = max(abs(a - b) for a, b in zip(change32, change64))
    if rounding > EULER_ROUNDING:
        failures.append(f"mass/energy change {change32} vs float64 {change64}: "
                        f"{rounding} > {EULER_ROUNDING}")
    # 3-D: a Sod state along x on the tetrahedral box.
    t3 = riemann_state(torch, tmesh.cell_centers, f32, dev)
    dt3 = cfl_dt(tmesh, float(np.sqrt(1.4)))
    solver3 = FvSolver(dm3, bcs={1: slip_bc})
    solver3.march(t3, dt3, 1)
    k3_before = banded_gather.launches
    u3, ms3 = _cuda_ms(torch, lambda: solver3.march(t3, dt3, EULER_3D_STEPS))
    st3 = state_from_cons(torch.zeros((u3.shape[0], 3), dtype=f32, device=dev), u3)
    m0, e0 = gas_totals(torch, dm3, t3)
    m1, e1 = gas_totals(torch, dm3, u3)
    run3 = dict(cells=tmesh.num_cells, steps=EULER_3D_STEPS, dt=dt3,
                ms_per_step=ms3 / EULER_3D_STEPS,
                k3_launches_per_step=(banded_gather.launches - k3_before) / EULER_3D_STEPS,
                finite=bool(torch.isfinite(u3).all()), min_rho=float(st3.rho.min()),
                min_p=float(st3.p.min()), mass_drift=abs(m1 - m0) / m0,
                energy_drift=abs(e1 - e0) / e0)
    run3["jax_plain_gather_plans"] = [n for n in FVM_CASES if getattr(dm3, "bg_" + n).xla_fallback]
    if run3["k3_launches_per_step"] != K3_PER_STEP[2]:
        failures.append(f"3-D: {run3['k3_launches_per_step']} K3 launches per step, not "
                        f"{K3_PER_STEP[2]}")
    if not (run3["finite"] and run3["min_rho"] > 0 and run3["min_p"] > 0):
        failures.append(f"3-D: non-finite or non-positive state: {run3}")
    if max(run3["mass_drift"], run3["energy_drift"]) > EULER_LEAK:
        failures.append(f"3-D: mass or energy drift {run3} > {EULER_LEAK}")
    emit("euler", cells=mesh.num_cells, dt=dt, cfl=EULER_CFL, **runs,
         profile_order2=prof, cpu_f64=dict(steps=EULER_CPU_STEPS, max_rel_gap=gap,
                                           mass_energy_change=change64,
                                           card_mass_energy_change=change32,
                                           change_gap=rounding, seconds=cpu_s),
         tet_box=run3, failures=failures)
    require(not failures, "; ".join(failures))
    del u, u5, u5_cpu, dm_cpu, u3, t3

    # -- 16. one implicit step (JFNK) in float64 through K3 ---------------------
    failures = []
    solver64 = FvSolver(dm64, order=2, bcs={1: slip_bc})
    calls = [0]
    calc = solver64.calc_func

    def counted(w):
        calls[0] += 1
        return calc(w)

    solver64.calc_func = counted
    w0 = smooth_state(torch, centers, f64, dev)
    dt_implicit = dt * IMPLICIT_CFL / EULER_CFL
    k3_before = banded_gather.launches
    t0 = time.perf_counter()
    res = solver64.implicit_step(w0, dt_implicit)
    torch.cuda.synchronize()
    implicit_s = time.perf_counter() - t0
    k3_implicit = banded_gather.launches - k3_before
    resid = float(torch.linalg.vector_norm(res.x + dt_implicit * calc(res.x) - w0)
                  / torch.linalg.vector_norm(w0))
    newton = res.num_iterations
    if not res.converged:
        failures.append(f"JFNK did not converge in {newton} iterations")
    if resid > IMPLICIT_RES:
        failures.append(f"true residual {resid} > {IMPLICIT_RES}·‖u0‖")
    emit("euler_implicit", cells=mesh.num_cells, dt=dt_implicit, cfl=IMPLICIT_CFL,
         dtype="float64",
         converged=res.converged, newton_iterations=newton,
         operator_applications=calls[0],
         inner_bicgstab_iterations=(calls[0] - 1 - 2 * newton) / 2,
         history=[_finite(h) for h in res.history[: newton + 1].cpu()],
         true_relative_residual=resid, seconds=implicit_s, k3_launches=k3_implicit,
         k3_launches_per_application=k3_implicit / max(calls[0], 1), failures=failures)
    require(not failures, "; ".join(failures))
    del res, w0

    # -- 17. convection-diffusion: BiCGStab + Jacobi through K1 -----------------
    failures = []
    c = centers
    rhs = np.sin(2 * np.pi * c[:, 0]) * np.cos(np.pi * c[:, 1]) + 0.1
    diag = ell.diagonal().numpy()
    jac = JacobiPreconditioner(diag=torch.as_tensor(diag[cd_perm], dtype=f32, device=dev))

    def bicgstab32(r, rtol, cap):
        """BiCGStab + Jacobi in float32 through K1 on r (host, original
        order); returns (x on the host in float64, result)."""
        rb = torch.as_tensor(r[cd_perm], dtype=f32, device=dev)
        res = bicgstab(make_operator(cd_op.matvec), rb, torch.zeros_like(rb), precond=jac,
                       options=SolverOptions(num_iterations=cap, absolute_tolerance=0.0,
                                             relative_tolerance=rtol, record_history=False))
        xh = np.empty(mesh.num_cells)
        xh[cd_perm] = res.x.double().cpu().numpy()
        return xh, res

    def true_res(xh):
        return float(np.linalg.norm(ell.matvec(torch.as_tensor(xh)).numpy() - rhs)
                     / np.linalg.norm(rhs))

    # Float64 iterative refinement, the smoke's own (the port has no such
    # entry point): r = b − A·x through the CSR in float64 on the CPU, d from
    # CONVDIFF_INNER_CAP float32 BiCGStab iterations on r/‖r‖ through K1,
    # x += ‖r‖·d.
    k1_before = sell_spmv.launches
    xr, outer, inner, t0 = np.zeros(mesh.num_cells), 0, 0, time.perf_counter()
    history = [true_res(xr)]
    while history[-1] > CONVDIFF_RTOL and outer < CONVDIFF_OUTER_CAP:
        r = rhs - ell.matvec(torch.as_tensor(xr)).numpy()
        scale = float(np.linalg.norm(r))
        d, res = bicgstab32(r / scale, CONVDIFF_INNER_RTOL, CONVDIFF_INNER_CAP)
        xr += scale * d
        inner += res.num_iterations
        outer += 1
        history.append(true_res(xr))
    refined_s = time.perf_counter() - t0
    if history[-1] > CONVDIFF_RTOL:
        failures.append(f"refinement: true residual {history[-1]} > {CONVDIFF_RTOL} after "
                        f"{outer} outer steps")
    emit("convdiff", cells=mesh.num_cells, nnz=nnz, operator_mode=cd_op.mode, eps=CONVDIFF_EPS,
         rtol=CONVDIFF_RTOL,
         refined=dict(outer_steps=outer, inner_iterations=inner, seconds=refined_s,
                      true_relative_residual=history),
         k1_launches=sell_spmv.launches - k1_before, failures=failures)
    require(not failures, "; ".join(failures))

    # -- 18. Laplace2D ------------------------------------------------------------
    laplace2d(LAPLACE_N, 2, device=dev)  # warm-up
    (u, err), ms = _cuda_ms(torch, lambda: laplace2d(LAPLACE_N, LAPLACE_SWEEPS, device=dev))
    err = float(err)
    lap = dict(n=LAPLACE_N, sweeps=LAPLACE_SWEEPS, error=err, golden=LAPLACE_GOLDEN,
               ms=ms, ms_per_sweep=ms / LAPLACE_SWEEPS, finite=bool(torch.isfinite(u).all()))
    failures = []
    if abs(err - LAPLACE_GOLDEN) > 1e-4:
        failures.append(f"error {err} is not within 1e-4 of {LAPLACE_GOLDEN}")
    emit("laplace2d", **lap, failures=failures)
    require(not failures, "; ".join(failures))

    # -- 19. one projection step --------------------------------------------------
    failures = []
    k3_before = banded_gather.launches
    (vel1, p, res, flux1), ms = _cuda_ms(torch, lambda: ns.step(vel0, NS_DT))
    k3_ns = banded_gather.launches - k3_before
    t0 = time.perf_counter()
    ns64 = NsProjection(ns_mesh, nu=1e-2, method="cg",
                        solver_kw={"options": SolverOptions(num_iterations=20_000,
                                                            absolute_tolerance=0.0,
                                                            relative_tolerance=1e-8,
                                                            record_history=False)},
                        banded_gather=False, dtype=f64, device="cpu")
    vel64, p64, res64, flux64 = ns64.step(torch.as_tensor(tg), NS_DT)
    cpu_s = time.perf_counter() - t0
    d0 = torch.linalg.vector_norm(cell_divergence(ns64.dmesh, torch.as_tensor(tg)))

    def div_ratio(flux):
        df = flux_divergence(ns64.dmesh, flux.double().cpu())
        return float(torch.linalg.vector_norm(df - df.mean()) / d0)

    ratios = {"float32": div_ratio(flux1), "float64": div_ratio(flux64)}
    # The same ratio from the card's pressure: dt·(b − A·p) in float64, b
    # from the card's own predicted velocity.
    div = flux_divergence(ns64.dmesh, face_fluxes(ns64.dmesh, v_star)) / NS_DT
    r = (div - div.mean()) - ns64._poisson.matvec(p.double().cpu())
    from_residual = float(NS_DT * torch.linalg.vector_norm(r - r.mean()) / d0)
    identity_gap = abs(ratios["float32"] - from_residual) / from_residual
    gaps = {name: float(torch.linalg.vector_norm(a.double().cpu() - b_)
                        / torch.linalg.vector_norm(b_))
            for name, a, b_ in (("vel", vel1, vel64), ("p", p, p64), ("flux", flux1, flux64))}
    if not res.converged:
        failures.append(f"the pressure CG did not converge in {res.num_iterations} iterations")
    if not res64.converged:
        failures.append("the CPU float64 projection's CG did not converge")
    for key, ratio in ratios.items():
        if ratio > NS_DIV_FRACTION[key]:
            failures.append(f"{key} face-flux divergence ratio {ratio} > {NS_DIV_FRACTION[key]}")
    if identity_gap > NS_IDENTITY:
        failures.append(f"the corrected divergence {ratios['float32']} is not dt·‖r‖ of its "
                        f"pressure, {from_residual}: {identity_gap} > {NS_IDENTITY}")
    if max(gaps.values()) > NS_CPU_GAP:
        failures.append(f"the step differs from the CPU float64 step: {gaps} > {NS_CPU_GAP}")
    emit("ns_projection", cells=ns_mesh.num_cells, mesh=f"structured_tri_rect({ns_side}, "
         f"{ns_side})", dt=NS_DT, method="cg", options=NS_OPTIONS, converged=res.converged,
         cg_iterations=res.num_iterations, step_ms=ms,
         ms_per_cg_iteration=ms / max(res.num_iterations, 1),
         corrected_flux_divergence_ratio=ratios, ratio_from_true_residual=from_residual,
         identity_gap=identity_gap, k3_launches=k3_ns,
         cpu_f64=dict(cg_iterations=res64.num_iterations, seconds=cpu_s, rel_gap=gaps),
         failures=failures)
    require(not failures, "; ".join(failures))

    kernels = []
    for entry, plan, key in cases:
        entry["launches"] = plan.launches_by_shape[key]
        entry["kernel_ms"] = entry["ms"]
        require(entry["launches"] > 0, f"{entry['name']} was not launched on the FVM path")
        kernels.append(entry)
    k1_entry["launches"] = sell_spmv.launches
    k1_entry["kernel_ms"] = k1_entry["ms"]
    require(k1_entry["launches"] > 0, "K1 was not launched in the convdiff phase")
    unchecked = [(label, n, key) for label, _, dm, _, _ in groups for n in FVM_CASES
                 for key in getattr(dm, "bg_" + n).launches_by_shape
                 if not any(p is getattr(dm, "bg_" + n) and k == key for _, p, k in cases)]
    require(not unchecked, f"K3 ran on the FVM path at unchecked shapes: {unchecked}")
    return kernels + [k1_entry]


def as_float64(torch, pre):
    """A shallow copy of a preconditioner with every floating tensor of its
    state (in triangular factors, CSRs and AMG levels too) in float64, on
    the same device: the float64 reference of a float32 case, without a
    second host build."""
    import copy
    import dataclasses

    from stormx_torch.precond import TriangularFactor

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.double() if v.is_floating_point() else v
        if isinstance(v, TriangularFactor):
            return v.astype(torch.float64)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: conv(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    out = copy.copy(pre)
    out.__dict__.update({k: conv(v) for k, v in vars(pre).items()})
    return out


def device_ell(torch, csr, dtype, dev):
    """A host CSR as a plain-PyTorch ELL operator on ``dev`` (the float64
    reference operators and true residuals: no kernel)."""
    from stormx_torch.sparse.formats import ELL, ell_from_csr

    ell = ell_from_csr(csr, device=False)
    return ELL(data=torch.as_tensor(ell.data, device=dev).to(dtype),
               cols=torch.as_tensor(ell.cols, device=dev), shape=ell.shape)


def launches_of(fn):
    """(fn(), K1 launches during the call), leaving K1's count as it was:
    the phases' timing and per-apply checks are not the path."""
    from stormx_torch.ops import sell_spmv

    before = sell_spmv.launches
    out = fn()
    n = sell_spmv.launches - before
    sell_spmv.launches = before
    return out, n


def precond_operators(torch, dev, mesh, lap, lap_perm, cd):
    """The implicit diffusion step V + τ·L and the convection-diffusion
    operator of one mesh, in their kernel operators' numbering: for each,
    (K1 operator in float32, plain float64 ELL, host float64 CSR, float64
    right-hand side).  ``lap`` is the mesh's Laplacian as a CSR, ``lap_perm``
    its bandwidth ordering; ``cd`` holds the convection-diffusion CSR, its
    K1 operator and its ordering."""
    from stormx_torch.sparse import CSR, sell_from_csr
    from stormx_torch.sparse.windowed import _permuted_csr

    n, c = mesh.num_cells, mesh.cell_centers
    l_csr, _ = _permuted_csr(lap, lap_perm)
    rows = np.repeat(np.arange(n), np.diff(l_csr.row_ptr))
    h_csr = CSR(data=DIFFUSION_TAU * l_csr.data + np.where(
        l_csr.indices == rows, mesh.cell_volumes[lap_perm][rows], 0.0),
        indices=l_csr.indices, row_ptr=l_csr.row_ptr, shape=l_csr.shape)
    h_op, _ = sell_from_csr(CSR(data=h_csr.data.astype(np.float32), indices=h_csr.indices,
                                row_ptr=h_csr.row_ptr, shape=h_csr.shape),
                            mode="cuda", reorder=False, device=dev)
    cd_csr, _ = _permuted_csr(cd["csr"], cd["perm"])
    b_cd = (np.sin(2 * np.pi * c[:, 0]) * np.cos(np.pi * c[:, 1]) + 0.1)[cd["perm"]]
    b_h = np.random.default_rng(2).standard_normal(n)
    return {"diffusion": (h_op, device_ell(torch, h_csr, torch.float64, dev), h_csr,
                          torch.as_tensor(b_h, device=dev)),
            "convdiff": (cd["op"], device_ell(torch, cd_csr, torch.float64, dev), cd_csr,
                         torch.as_tensor(b_cd, device=dev))}


def run_precond(torch, dev, ctx: dict) -> dict:
    """Phase 20, the preconditioners, float32 on the card, on phase 2's mesh
    (SPAI(0) and AINV on a smaller one of the same kind, ``PRECOND_SMALL_SIDE``,
    to keep the phase's time).  Returns K1's entry on the diffusion operator
    with the phase's launches."""
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import build_mesh
    from stormx_torch.ops import sell_spmv
    from stormx_torch.precond import (AinvPreconditioner, AmgPreconditioner,
                                      BlockJacobiPreconditioner, ChebyshevPreconditioner,
                                      IcPreconditioner, IluPreconditioner, JacobiPreconditioner,
                                      KrylovPreconditioner, SgsPreconditioner,
                                      SpaiPreconditioner, tri_solve)
    from stormx_torch.solvers import SOLVERS, SolverOptions, make_operator
    from stormx_torch.sparse import CSR, auto_operator, bsr_from_csr

    f32, f64 = torch.float32, torch.float64
    mesh = ctx["mesh"]
    n = mesh.num_cells

    # -- the operators ------------------------------------------------------------
    t0 = time.perf_counter()
    ops = precond_operators(torch, dev, mesh, ctx["laplacian"].to_csr(), ctx["perm"],
                            ctx["convdiff"])
    ch_csr = sell_to_csr(ctx["ch_op"])  # float32, as the CH step assembles it
    ops["ch"] = (ctx["ch_op"], device_ell(torch, ch_csr, f64, dev), ch_csr,
                 torch.as_tensor(np.random.default_rng(3).standard_normal(n), device=dev))
    # The smaller mesh: the same jittered grid at PRECOND_SMALL_SIDE.
    small = build_mesh(*delaunay_mesh(PRECOND_SMALL_SIDE, JITTER, seed=0)).optimize_ordering()
    s_lap = assemble_laplacian(small).to_csr()
    s_cd = assemble_convection_diffusion(small, rotating_velocity, CONVDIFF_EPS).to_csr()
    coords = small.cell_centers
    _, s_perm = auto_operator(CSR(data=s_lap.data.float(), indices=s_lap.indices,
                                  row_ptr=s_lap.row_ptr, shape=s_lap.shape),
                              coords=coords, device=dev)
    s_cd_op, s_cd_perm = auto_operator(CSR(data=s_cd.data.float(), indices=s_cd.indices,
                                           row_ptr=s_cd.row_ptr, shape=s_cd.shape),
                                       coords=coords, device=dev)
    small_ops = precond_operators(torch, dev, small, s_lap, s_perm,
                                  dict(csr=s_cd, op=s_cd_op, perm=s_cd_perm))
    # IC(0) of the CH operator meets a non-positive pivot (AINV too; the JAX
    # package's host code, which the port copies, does the same).
    try:
        IcPreconditioner(ch_csr, dtype=f32, device=dev)
        ic0_on_ch = "no breakdown"
    except ValueError as err:
        ic0_on_ch = str(err)
    prep_s = time.perf_counter() - t0

    # -- K1 on the diffusion operator, against its plain version ------------------
    h_op, _, h_csr, _ = ops["diffusion"]
    gen = torch.Generator(device="cpu").manual_seed(20)
    x = torch.randn(n, generator=gen, dtype=f32).to(dev)
    y_k, y_p = sell_spmv.sell_spmv_cuda(h_op, x), sell_spmv.sell_spmv_plain(h_op, x)
    torch.cuda.synchronize()
    k1_err, k1_scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    require(k1_err <= 1e-5 * k1_scale, f"K1 on the diffusion operator: {k1_err} > 1e-5·{k1_scale}")
    h_host = sell_to_csr(h_op)
    a_csr, nnz = torch_csr(torch, h_host, dev), int(h_host.nnz)
    b_ms, b_by = bound_ms(8.0 * nnz + 8.0 * n, 2.0 * nnz)
    k1_entry = dict(
        name="sell_spmv/precond", route="cuda", source="stormx_torch/csrc/sell_spmv.cu",
        replaces="stormx/ops/pallas_sell.py:64", tpu_source="stormx/ops/pallas_sell.py:_kernel",
        shape=dict(rows=n, nnz=nnz, K=h_op.data.shape[1], R=h_op.data.shape[2],
                   window=h_op.window, operator="diffusion"),
        ok=True, max_abs_err=k1_err, max_err=k1_err, max_abs_y=k1_scale,
        ms=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(h_op, x)),
        plain_ms=time_ms(torch, lambda: sell_spmv.sell_spmv_plain(h_op, x)),
        library_ms=time_ms(torch, lambda: a_csr @ x),
        library_call="torch.sparse_csr_tensor @ x", bound_ms=b_ms, bound_by=b_by)
    del a_csr, y_k, y_p

    # The path: every count at 0 just before.
    sell_spmv.launches = 0
    cases, failures = [], []

    def solve(name, method, opname, pre, pre64, build_s, *, on=ops, **extra):
        """One case: the float32 solve through K1 on the card, timed, and the
        same case in float64 through the plain operator; gated on convergence,
        the float64 true residual and the iteration gap."""
        op32, op64, _, b64 = on[opname]
        b32 = b64.float()
        rtol = PRECOND_RTOL[opname]
        opts = SolverOptions(num_iterations=PRECOND_MAX_ITERATIONS, absolute_tolerance=0.0,
                             relative_tolerance=rtol, record_history=False)
        kw = {"orthog": "cgs2"} if method == "fgmres" else {}
        fn = SOLVERS[method]
        k1_before = sell_spmv.launches
        res, ms = _cuda_ms(torch, lambda: fn(make_operator(op32.matvec), b32,
                                              torch.zeros_like(b32), precond=pre, options=opts,
                                              **kw))
        k1 = sell_spmv.launches - k1_before
        r = b64 - op64.matvec(res.x.double())
        true_res = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
        t0 = time.perf_counter()
        ref = fn(make_operator(op64.matvec), b64, torch.zeros_like(b64), precond=pre64,
                 options=opts, **kw)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        it, it64 = res.num_iterations, ref.num_iterations
        apply_ms = time_ms(torch, lambda: pre(b32), reps=10, warmup=2)
        _, k1_apply = launches_of(lambda: pre(b32))
        case = dict(name=name, method=method, operator=opname, cells=b64.shape[0], rtol=rtol,
                    converged=res.converged, iterations=it, solve_ms=ms,
                    ms_per_iteration=ms / max(it, 1), ms_per_apply=apply_ms, k1_launches=k1,
                    k1_launches_per_apply=k1_apply, host_build_s=build_s,
                    true_relative_residual=true_res,
                    f64=dict(converged=ref.converged, iterations=it64, seconds=ref_s), **extra)
        gate = PRECOND_TRUE_RES[opname]
        gap = PRECOND_ITERATION_GAP.get(name, PRECOND_ITERATION_GAP_DEFAULT)
        if not res.converged:
            failures.append(f"{name}: did not converge in {it} iterations")
        if not ref.converged:
            failures.append(f"{name}: the float64 run did not converge in {it64} iterations")
        if true_res > gate:
            failures.append(f"{name}: true residual {true_res} > {gate}")
        if abs(it - it64) > gap * it64 + 2:
            failures.append(f"{name}: {it} iterations against {it64} in float64")
        cases.append(case)
        return case

    def timed(build):
        t0 = time.perf_counter()
        pre = build()
        torch.cuda.synchronize()
        return pre, time.perf_counter() - t0

    h_diag = torch.as_tensor(h_csr.data[h_csr.indices == np.repeat(
        np.arange(n), np.diff(h_csr.row_ptr))], device=dev)
    solve("jacobi", "cg", "diffusion", JacobiPreconditioner(diag=h_diag.float()),
          JacobiPreconditioner(diag=h_diag), 0.0)

    # AMG, its fine level through K1.
    amg, amg_s = timed(lambda: AmgPreconditioner(
        h_csr, num_sweeps=PRECOND_AMG_SWEEPS, fine_matvec=h_op.matvec, dtype=f32, device=dev))
    amg64 = as_float64(torch, amg)
    amg64._fine_matvec = ops["diffusion"][1].matvec
    case = solve("amg", "cg", "diffusion", amg, amg64, amg_s,
                 levels=[lvl["n"] for lvl in amg._levels] + [amg._coarse_inv.shape[0]])
    if case["k1_launches_per_apply"] != 2 * PRECOND_AMG_SWEEPS + 1:
        failures.append(f"amg: {case['k1_launches_per_apply']} K1 launches per V-cycle, not "
                        f"{2 * PRECOND_AMG_SWEEPS + 1}")

    # Chebyshev, λmax by power iteration through K1.
    b32 = ops["diffusion"][3].float()
    k1_before = sell_spmv.launches
    cheb, cheb_s = timed(lambda: ChebyshevPreconditioner(PRECOND_CHEB_DEGREE).build(
        None, b32, h_op.matvec))
    cheb_k1 = sell_spmv.launches - k1_before
    cheb64 = ChebyshevPreconditioner(PRECOND_CHEB_DEGREE).build(None, ops["diffusion"][3],
                                                                ops["diffusion"][1].matvec)
    case = solve("chebyshev", "cg", "diffusion", cheb, cheb64, cheb_s,
                 lambda_max=float(cheb._lmax), lambda_max_f64=float(cheb64._lmax),
                 k1_launches_in_build=cheb_k1)
    if case["k1_launches_per_apply"] != PRECOND_CHEB_DEGREE or cheb_k1 != cheb.power_iters:
        failures.append(f"chebyshev: {case['k1_launches_per_apply']} K1 launches per apply "
                        f"and {cheb_k1} in its build, not {PRECOND_CHEB_DEGREE} and "
                        f"{cheb.power_iters}")

    # IC(0) on the diffusion operator and SGS on the CH operator, in sweeps
    # mode, each with one exact lower solve timed and checked.
    for name, cls, opname in (("ic0", IcPreconditioner, "diffusion"),
                              ("sgs", SgsPreconditioner, "ch")):
        csr, b64 = ops[opname][2], ops[opname][3]
        pre, build_s = timed(lambda cls=cls, csr=csr: cls(csr, sweeps=PRECOND_TRI_SWEEPS,
                                                          dtype=f32, device=dev))
        pre64 = as_float64(torch, pre)
        y, exact_ms = _cuda_ms(torch, lambda pre=pre: tri_solve(pre._first, b64.float()))
        tri = pre64._first
        y_pad = torch.nn.functional.pad(y.double(), (0, 1))
        ty = y_pad[:n] / tri.inv_diag[:n] + (tri.ell_vals[:n] * y_pad[tri.ell_cols[:n]]).sum(1)
        exact_res = float(torch.linalg.vector_norm(ty - b64) / torch.linalg.vector_norm(b64))
        if exact_res > PRECOND_TRI_EXACT_RES:
            failures.append(f"{name}: the exact lower solve's residual {exact_res} > "
                            f"{PRECOND_TRI_EXACT_RES}")
        solve(name, "cg", opname, pre, pre64, build_s, sweeps=PRECOND_TRI_SWEEPS,
              num_levels=[pre._first.num_levels, pre._second.num_levels],
              exact_lower_solve=dict(ms=exact_ms, relative_residual=exact_res))

    # ILU(0) on the convection-diffusion operator, under FGMRES.
    ilu, ilu_s = timed(lambda: IluPreconditioner(ops["convdiff"][2], sweeps=PRECOND_TRI_SWEEPS,
                                                 dtype=f32, device=dev))
    solve("ilu0", "fgmres", "convdiff", ilu, as_float64(torch, ilu), ilu_s,
          sweeps=PRECOND_TRI_SWEEPS, num_levels=[ilu._first.num_levels, ilu._second.num_levels])

    # SPAI(0) (convection-diffusion, FGMRES) and AINV (diffusion, CG) on the
    # smaller mesh.
    spai, spai_s = timed(lambda: SpaiPreconditioner(small_ops["convdiff"][2], dtype=f32,
                                                    device=dev))
    solve("spai0", "fgmres", "convdiff", spai, as_float64(torch, spai), spai_s, on=small_ops,
          m_nnz=int(spai._m.nnz))
    ainv, ainv_s = timed(lambda: AinvPreconditioner(small_ops["diffusion"][2], dtype=f32,
                                                    device=dev))
    solve("ainv", "cg", "diffusion", ainv, as_float64(torch, ainv), ainv_s, on=small_ops,
          z_nnz=int(ainv._z.nnz))

    # Block-Jacobi through BSR at b = 2 and 3 (318,402 rows divide by both).
    for bs in PRECOND_BLOCK_SIZES:
        def build(bs=bs):
            bsr = bsr_from_csr(h_csr, bs)
            bsr = type(bsr)(blocks=torch.as_tensor(bsr.blocks, device=dev).float(),
                            cols=torch.as_tensor(bsr.cols, device=dev), shape=bsr.shape)
            return bsr, BlockJacobiPreconditioner(matrix=bsr)

        (bsr, bj), build_s = timed(build)
        bj64 = BlockJacobiPreconditioner(blocks=bsr.diagonal_blocks().double())
        y_b, y_1 = bsr.matvec(b32), h_op.matvec(b32)
        solve(f"block_jacobi{bs}", "cg", "diffusion", bj, bj64, build_s, block_size=bs,
              bsr_block_row_width=int(bsr.cols.shape[1]),
              bsr_matvec_ms=time_ms(torch, lambda bsr=bsr: bsr.matvec(b32), reps=10),
              k1_ms=k1_entry["ms"],
              bsr_matvec_gap=float((y_b - y_1).abs().max() / y_1.abs().max()))

    # A Krylov inner solve (8 CG iterations) under FGMRES.
    solve("krylov", "fgmres", "diffusion",
          KrylovPreconditioner(method="cg", num_iterations=PRECOND_KRYLOV_INNER),
          KrylovPreconditioner(method="cg", num_iterations=PRECOND_KRYLOV_INNER), 0.0,
          inner_iterations=PRECOND_KRYLOV_INNER)

    k1_entry["launches"] = sell_spmv.launches
    k1_entry["kernel_ms"] = k1_entry["ms"]
    emit("precond", cells=n, small_cells=small.num_cells, prep_s=prep_s,
         diffusion_tau=DIFFUSION_TAU, ic0_on_ch=ic0_on_ch, cases=cases,
         k1_launches=sell_spmv.launches, failures=failures)
    require(not failures, "; ".join(failures))
    require(sell_spmv.launches > 0, "K1 was not launched in the precond phase")
    return k1_entry


def face_difference(mesh):
    """The face-difference matrix of a mesh as host CSR triples: an interior
    face gives the row x[outer] − x[inner], a boundary face the row
    x[inner]."""
    fc = mesh.face_cells
    inner, outer = fc[:, 0].astype(np.int64), fc[:, 1].astype(np.int64)
    interior = outer >= 0
    m, n = len(fc), mesh.num_cells
    rows = np.concatenate([np.arange(m), np.nonzero(interior)[0]])
    cols = np.concatenate([inner, outer[interior]])
    vals = np.concatenate([np.where(interior, -1.0, 1.0), np.ones(int(interior.sum()))])
    order = np.lexsort((cols, rows))
    rp = np.zeros(m + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return np.cumsum(rp), cols[order], vals[order], (m, n)


def run_lsq(torch, dev, ctx: dict) -> None:
    """Phase 21, LSQR and LSMR, plain and with IQR, on the face-difference
    matrix of phase 2's mesh."""
    from stormx_torch.precond import AmgPreconditioner, IqrPreconditioner
    from stormx_torch.solvers import SolverOptions, cg, lsmr, lsqr, make_operator
    from stormx_torch.sparse.formats import CSR, ell_from_csr, ell_spgemm

    f32, f64 = torch.float32, torch.float64
    mesh = ctx["mesh"]
    t0 = time.perf_counter()
    rp, cols, vals, (m, n) = face_difference(mesh)
    a_host = CSR(data=vals, indices=cols.astype(np.int32), row_ptr=rp.astype(np.int32),
                 shape=(m, n))
    rows = np.repeat(np.arange(m), np.diff(rp))
    order = np.lexsort((rows, cols))
    tp_ = np.zeros(n + 1, dtype=np.int64)
    np.add.at(tp_, cols + 1, 1)
    at_host = CSR(data=vals[order], indices=rows[order].astype(np.int32),
                  row_ptr=np.cumsum(tp_).astype(np.int32), shape=(n, m))

    def on_card(csr, dtype):
        return CSR(data=torch.as_tensor(csr.data, device=dev).to(dtype),
                   indices=torch.as_tensor(csr.indices, device=dev),
                   row_ptr=torch.as_tensor(csr.row_ptr, device=dev), shape=csr.shape)

    mats = {dt: (on_card(a_host, dt), on_card(at_host, dt)) for dt in (f32, f64)}
    c = mesh.cell_centers
    x_true = np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
    noise = LSQ_NOISE * np.random.default_rng(0).standard_normal(m)
    b_host = np.zeros(m)
    np.add.at(b_host, rows, vals * x_true[cols])
    b_host += noise
    b64 = torch.as_tensor(b_host, device=dev)
    # The least-squares solution: CG + AMG on AᵀA = Aᵀb in float64.
    ata = ell_spgemm(ell_from_csr(at_host, device=False), ell_from_csr(a_host, device=False))
    prep_s = time.perf_counter() - t0
    a64, at64 = mats[f64]
    atb = at64.matvec(b64)
    t0 = time.perf_counter()
    ata64 = on_card(ata, f64)
    ref = cg(make_operator(ata64.matvec), atb, torch.zeros_like(atb),
             precond=AmgPreconditioner(ata, dtype=f64, device=dev),
             options=SolverOptions(num_iterations=2000, absolute_tolerance=0.0,
                                   relative_tolerance=1e-12, record_history=False))
    x_ls = ref.x
    ls_s = time.perf_counter() - t0
    failures = []
    if not ref.converged:
        failures.append(f"the least-squares reference did not converge ({ref.num_iterations})")

    t0 = time.perf_counter()
    iqr = IqrPreconditioner(a_host, sweeps=LSQ_SWEEPS, dtype=f32, device=dev)
    iqr_s = time.perf_counter() - t0
    iqr64 = as_float64(torch, iqr)

    def normal_residual(x):
        r = b64 - a64.matvec(x.double())
        return float(torch.linalg.vector_norm(at64.matvec(r)) / torch.linalg.vector_norm(atb))

    runs = {}
    opts = SolverOptions(num_iterations=LSQ_BUDGET, absolute_tolerance=0.0,
                         relative_tolerance=0.0, record_history=False)
    for method, fn in (("lsqr", lsqr), ("lsmr", lsmr)):
        for label, pre, pre64 in (("plain", None, None), ("iqr", iqr, iqr64)):
            a, at = mats[f32]
            res, ms = _cuda_ms(torch, lambda: fn(make_operator(a.matvec, at.matvec), b64.float(),
                                                  torch.zeros(n, dtype=f32, device=dev),
                                                  precond=pre, options=opts))
            t0 = time.perf_counter()
            res64 = fn(make_operator(a64.matvec, at64.matvec), b64, torch.zeros_like(x_ls),
                       precond=pre64, options=opts)
            torch.cuda.synchronize()
            s64 = time.perf_counter() - t0
            err = float(torch.linalg.vector_norm(res.x.double() - x_ls)
                        / torch.linalg.vector_norm(x_ls))
            err64 = float(torch.linalg.vector_norm(res64.x - x_ls) / torch.linalg.vector_norm(x_ls))
            gap = float(torch.linalg.vector_norm(res.x.double() - res64.x)
                        / torch.linalg.vector_norm(res64.x))
            run = dict(iterations=res.num_iterations, solve_ms=ms,
                       ms_per_iteration=ms / LSQ_BUDGET, normal_residual=normal_residual(res.x),
                       error=err, f64=dict(normal_residual=normal_residual(res64.x), error=err64,
                                           seconds=s64), gap_to_f64=gap,
                       finite=bool(torch.isfinite(res.x).all()))
            runs[f"{method}/{label}"] = run
            if not run["finite"]:
                failures.append(f"{method}/{label}: non-finite solution")
            if run["normal_residual"] > LSQ_NORMAL_RES[label]:
                failures.append(f"{method}/{label}: ‖Aᵀr‖/‖Aᵀb‖ {run['normal_residual']} > "
                                f"{LSQ_NORMAL_RES[label]}")
            if gap > LSQ_F64_GAP:
                failures.append(f"{method}/{label}: {gap} from the float64 run > {LSQ_F64_GAP}")
        if not runs[f"{method}/iqr"]["error"] < runs[f"{method}/plain"]["error"]:
            failures.append(f"{method}: IQR's error {runs[f'{method}/iqr']['error']} is not "
                            f"below the plain run's {runs[f'{method}/plain']['error']}")
    emit("lsq", rows=m, cols=n, nnz=int(len(vals)), noise=LSQ_NOISE, budget=LSQ_BUDGET,
         prep_s=prep_s, least_squares_reference=dict(cg_amg_iterations=ref.num_iterations,
                                                      seconds=ls_s),
         iqr=dict(host_build_s=iqr_s, mode="exact" if LSQ_SWEEPS is None else "sweeps",
                  sweeps=LSQ_SWEEPS, num_levels=[iqr._r.num_levels, iqr._rt.num_levels],
                  ms_per_apply=time_ms(torch, lambda: iqr(torch.ones(n, device=dev)), reps=10),
                  ms_per_adjoint_apply=time_ms(torch, lambda: iqr.conj_apply(
                      torch.ones(n, device=dev)), reps=10)),
         dtype="float32", runs=runs, failures=failures)
    require(not failures, "; ".join(failures))


def complex_field(torch, n: int, gen, dtype, dev):
    re = torch.randn(n, generator=gen, dtype=torch.float64)
    im = torch.randn(n, generator=gen, dtype=torch.float64)
    return torch.complex(re, im).to(dtype).to(dev)


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two complex tensors."""
    ar, br = torch.view_as_real(a), torch.view_as_real(b)
    word = torch.int64 if ar.dtype == torch.float64 else torch.int32
    return torch.equal(ar.contiguous().view(word), br.contiguous().view(word))


def gershgorin_lmax(mesh) -> float:
    """Gershgorin's bound on λmax(−Δ) of ``div_grad`` on ``mesh``."""
    fc = mesh.face_cells
    inner = fc[:, 1] >= 0
    d = np.linalg.norm(mesh.cell_centers[fc[inner, 1]] - mesh.cell_centers[fc[inner, 0]], axis=1)
    coef = mesh.face_areas[inner] / d
    row = np.zeros(mesh.num_cells)
    np.add.at(row, fc[inner, 0], coef)
    np.add.at(row, fc[inner, 1], coef)
    return float(2 * np.max(row / mesh.cell_volumes))


def rtol_of(method: str, dtype: str) -> float:
    return (COMPLEX_LSQ_RTOL if method in ("lsqr", "lsmr") else COMPLEX_RTOL)[dtype]


def run_complex(torch, dev, ctx: dict) -> list:
    """Phase 22, every solver of the catalogue on complex operators built
    from ``div_grad`` through K3, at complex128 (float64 mesh) and complex64
    (float32 mesh).  Returns K3's complex64 and complex128 entries with their
    launches in the phase's solves."""
    from stormx_torch import solvers as ts
    from stormx_torch.fvm.divgrad import div_grad
    from stormx_torch.mesh import structured_tri_rect
    from stormx_torch.ops import banded_gather

    f32, f64 = torch.float32, torch.float64
    c64, c128 = torch.complex64, torch.complex128
    t0 = time.perf_counter()
    mesh = ctx.get("ns_mesh") or structured_tri_rect(NS_SIDE, NS_SIDE).optimize_ordering()
    volumes = mesh.cell_volumes
    require(np.ptp(volumes) <= 1e-12 * volumes.max(), "the complex phase's cells differ in volume")
    dms = {c128: mesh.device_arrays(f64, device=dev, banded_gather=True),
           c64: mesh.device_arrays(f32, device=dev, banded_gather=True)}
    d_plain = mesh.device_arrays(f64, device=dev, banded_gather=False)
    lmax = gershgorin_lmax(mesh)
    omega = 2.0 / (2.0 + COMPLEX_TAU * lmax)
    setup_s = time.perf_counter() - t0
    tau, kappa = COMPLEX_TAU, COMPLEX_KAPPA

    def operators(dm):
        return (lambda c: div_grad(dm, c, -tau, c),
                lambda c: div_grad(dm, (1 + 1j * kappa) * c, -tau, c),
                lambda c: div_grad(dm, (1 - 1j * kappa) * c, -tau, c))

    # -- K3 on complex fields at the phase's shapes (not counted) ------------
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=f32, device=dev)  # 128 MB > L2
    gen = torch.Generator(device="cpu").manual_seed(22)
    entries, failures = [], []
    for dtype in (c64, c128):
        dm = dms[dtype]
        for name in ("face_inner", "face_outer", "cell_face"):
            plan = getattr(dm, "bg_" + name)
            idx = torch.as_tensor(plan_index(mesh, dm, name), dtype=torch.int64, device=dev)
            x = complex_field(torch, plan.n_src, gen, dtype, dev)
            tag = f"banded_gather/complex/{name}/{str(dtype).split('.')[-1]}"
            try:
                e = k3_case(torch, plan, x, idx, flush, dev)
            except RuntimeError as err:
                failures.append(f"{tag}: {err}")
                continue
            if not bits_equal(torch, banded_gather.banded_gather_cuda(plan, x),
                              banded_gather.banded_gather_plain(plan, x)):
                failures.append(f"{tag}: not bit-exact")
            entries.append((dict(name=tag, route="cuda", source="stormx_torch/csrc/banded_gather.cu",
                                 replaces="stormx/ops/pallas_gather.py:40",
                                 tpu_source="stormx/ops/pallas_gather.py:_kernel",
                                 shape=dict(m=plan.m, n_src=plan.n_src, nv=1,
                                            dtype=str(dtype).split(".")[-1], window=plan.window,
                                            fixups=int(plan.fix_pos.numel())), **e),
                            plan, (1, dtype)))
    del flush
    require(not failures, "; ".join(failures))

    # -- the solves, with every count at 0 just before ------------------------
    banded_gather.launches = 0
    for dm in dms.values():
        for name in ("face_inner", "face_outer", "cell_face", "cell_adj"):
            getattr(dm, "bg_" + name).launches_by_shape.clear()
    rows, results = [], {}
    b128 = complex_field(torch, mesh.num_cells, torch.Generator(device="cpu").manual_seed(0),
                         c128, dev)
    for dtype in (c128, c64):
        key = str(dtype).split(".")[-1]
        a_h, a_g, a_gh = operators(dms[dtype])
        b = b128.to(dtype)
        for method in COMPLEX_METHODS:
            op = ts.make_operator(a_h) if method == "cg" else ts.make_operator(a_g, a_gh)
            kw = dict(relaxation_factor=omega) if method == "richardson" else {}
            opts = ts.SolverOptions(num_iterations=COMPLEX_CAP.get(method, COMPLEX_CAP_DEFAULT),
                                    absolute_tolerance=0.0, relative_tolerance=rtol_of(method, key))
            k3_before = banded_gather.launches
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = getattr(ts, method)(op, b, torch.zeros_like(b), options=opts, **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            it = res.num_iterations
            results[(key, method)] = res
            rows.append(dict(dtype=key, method=method, converged=res.converged, iterations=it,
                             ms_per_solve=ms, ms_per_iteration=ms / max(it, 1),
                             k3_launches_per_iteration=(banded_gather.launches - k3_before)
                             / max(it, 1),
                             history_dtype=str(res.history.dtype).split(".")[-1]))
    launches = {f"{n}/{str(d).split('.')[-1]}": getattr(dm, "bg_" + n).launches_by_shape[(1, d)]
                for d, dm in dms.items() for n in ("face_inner", "face_outer", "cell_face")}

    # -- the gates ----------------------------------------------------------
    p_h, p_g, _ = operators(d_plain)
    tol128 = {m: rtol_of(m, "complex128") for m in COMPLEX_METHODS}
    bn = float(torch.linalg.vector_norm(b128))
    for row in rows:
        res = results[(row["dtype"], row["method"])]
        if res.history.is_complex():
            failures.append(f"{row['dtype']} {row['method']}: the history is complex")
        if not res.converged:
            failures.append(f"{row['dtype']} {row['method']}: did not converge in "
                            f"{row['iterations']} iterations")
            continue
        if row["dtype"] == "complex128":
            A = p_h if row["method"] == "cg" else p_g
            true = float(torch.linalg.vector_norm(A(res.x) - b128)) / bn
            row["true_residual"] = true
            if true > COMPLEX_TRUE_RES * tol128[row["method"]]:
                failures.append(f"complex128 {row['method']}: true residual {true:.3e} > "
                                f"{COMPLEX_TRUE_RES}·{tol128[row['method']]}")
            continue
        ref = results[("complex128", row["method"])]
        if not ref.converged:
            continue
        h = (ref.history[: ref.num_iterations + 1] / ref.history[0]).cpu().numpy()
        it_ref = int(np.argmax(h < rtol_of(row["method"], "complex64")))
        x_gap = float(torch.linalg.vector_norm(res.x.to(c128) - ref.x)
                      / torch.linalg.vector_norm(ref.x))
        row.update(complex128_iterations_to_rtol=it_ref, solution_gap=x_gap)
        if abs(row["iterations"] - it_ref) > COMPLEX64_ITERATION_GAP * it_ref + 2:
            failures.append(f"complex64 {row['method']}: {row['iterations']} iterations against "
                            f"complex128's {it_ref} to the same tolerance")
        if x_gap > COMPLEX64_SOLUTION_GAP * rtol_of(row["method"], "complex64"):
            failures.append(f"complex64 {row['method']}: solution {x_gap:.3e} from complex128's")
    for d in ("complex64", "complex128"):
        if not any(v for k, v in launches.items() if k.endswith(d)):
            failures.append(f"K3 was not launched on {d} fields in the complex phase")
    k3 = {e["name"]: dict(ms_warm=e["ms"], ms_flushed=e["ms_l2_flushed"], plain_ms=e["plain_ms"],
                          index_select_ms=e["library_ms"], bound_ms=e["bound_ms"])
          for e, _, _ in entries}
    emit("complex", cells=mesh.num_cells, tau=tau, kappa=kappa, lmax_gershgorin=lmax,
         richardson_omega=omega, rtol=COMPLEX_RTOL, lsq_rtol=COMPLEX_LSQ_RTOL, setup_s=setup_s,
         solves=rows,
         k3_launches=launches, k3=k3, failures=failures)
    require(not failures, "; ".join(failures))
    out = []
    for e, plan, shape in entries:
        e["launches"] = plan.launches_by_shape[shape]
        out.append(e)
    return out


def trace_kernels_in(trace_dir: str, region: str) -> list:
    """The CUDA kernel names that the Chrome trace ``trace`` wrote into
    ``trace_dir`` holds inside the annotated ``region``: kernels launched
    (runtime call, matched by correlation id) inside the region's CPU span,
    or running inside its GPU span."""
    names = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(names) != 1:
        return []
    with open(os.path.join(trace_dir, names[0])) as f:
        events = json.load(f).get("traceEvents", [])

    def spans(cat):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == region and e.get("cat") == cat and "dur" in e]

    def within(e, sp):
        return any(a <= e["ts"] <= b for a, b in sp)

    cpu, gpu = spans("user_annotation"), spans("gpu_user_annotation")
    launched = {e["args"].get("correlation") for e in events
                if e.get("cat") == "cuda_runtime" and "args" in e and within(e, cpu)}
    return sorted({e["name"] for e in events if e.get("cat") == "kernel" and (
        e.get("args", {}).get("correlation") in launched or within(e, gpu))})


def run_io(torch, dev, ctx: dict) -> dict:
    """Phase 23, the CH entry points' side channels on the main path: VTK
    snapshots and checkpoints from ``run``, a resume, ``main``, a trace with
    an annotated region, ``checked`` on the card and a deterministic
    ``segment_sum``.  Returns the phase's K1 and K3 launches."""
    from stormx_torch.apps.cahn_hilliard import main as ch_main
    from stormx_torch.apps.cahn_hilliard import make_assembled_step, run
    from stormx_torch.core import annotate, assert_deterministic, checked, trace
    from stormx_torch.io import Checkpointer, load_checkpoint, save_checkpoint, write_vtk
    from stormx_torch.ops import banded_gather, segment_sum, sell_spmv
    from stormx_torch.solvers import SolverOptions

    f32 = torch.float32
    mesh = ctx["mesh"]
    ch_opts = SolverOptions(**CH_OPTIONS)
    kw = dict(mesh=mesh, assembled=True, options=ch_opts, dtype=f32, device=dev)
    dmesh = mesh.device_arrays(f32, device=dev)
    rng = np.random.default_rng(0)
    c0 = torch.as_tensor(0.5 + 0.1 * rng.standard_normal(mesh.num_cells), dtype=f32, device=dev)
    failures = []
    sell_spmv.launches = 0
    banded_gather.launches = 0
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        # 1. run with snapshots every 5 steps and a checkpointer.
        t0 = time.perf_counter()
        step = make_assembled_step(mesh, options=ch_opts, dtype=f32, device=dev)
        build_s = time.perf_counter() - t0
        out_dir = os.path.join(tmp, "out")
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        c_full = run(dmesh, c0, IO_STEPS, output_every=IO_EVERY, output_dir=out_dir,
                     checkpointer=Checkpointer(os.path.join(tmp, "ck"), every=IO_EVERY), **kw)
        torch.cuda.synchronize()
        run_side_s = time.perf_counter() - t0
        snaps = sorted(os.listdir(out_dir))
        want = [f"out_cahn_hilliard_{k}.vtk" for k in range(IO_EVERY, IO_STEPS + 1, IO_EVERY)]
        if snaps != sorted(want):
            failures.append(f"run wrote {snaps}, not {want}")
        # 3. the snapshot's header counts.
        with open(os.path.join(out_dir, want[-1])) as f:
            text = f.read()
        heads = [ln for ln in text.splitlines() if ln[:6] in ("POINTS", "CELLS ", "CELL_T", "CELL_D")]
        total = int((mesh.cell_nodes >= 0).sum()) + mesh.num_cells
        expect = [f"POINTS {mesh.num_nodes} double", f"CELLS {mesh.num_cells} {total}",
                  f"CELL_TYPES {mesh.num_cells}", f"CELL_DATA {mesh.num_cells}"]
        if heads != expect:
            failures.append(f"VTK header {heads} != {expect}")
        vals = np.array(text.split("LOOKUP_TABLE default\n", 1)[1].split(), dtype=np.float64)
        if not np.array_equal(vals.astype(np.float32), c_full.cpu().numpy()):
            failures.append("the last snapshot's values are not the returned field")
        # 2. resume from the step-5 checkpoint.
        (c5, step5), _ = load_checkpoint(os.path.join(tmp, "ck"), IO_EVERY)
        t0 = time.perf_counter()
        c_resumed = run(dmesh, torch.as_tensor(c5, device=dev), IO_STEPS - IO_EVERY,
                        start_step=int(step5),
                        checkpointer=Checkpointer(os.path.join(tmp, "ck2"), every=IO_EVERY), **kw)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        resume_equal = bool(torch.equal(c_resumed, c_full))
        if not resume_equal:
            failures.append("the resumed run is not bit-equal to the uninterrupted one")
        # The first step, twice: timed, and bit-equal.
        step_ms = []

        def timed_step():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            c1, _ = step(c0)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            return c1

        try:
            assert_deterministic(timed_step)
            step_deterministic = True
        except AssertionError as err:
            step_deterministic = False
            failures.append(f"one CH step is not deterministic: {err}")
        # What one snapshot and one checkpoint cost.
        t0 = time.perf_counter()
        write_vtk(mesh, os.path.join(tmp, "one.vtk"), {"c": c_full})
        snapshot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "ck3"), 1, {"c": c_full, "step": 1})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        (c_back, _), _ = load_checkpoint(os.path.join(tmp, "ck3"))
        load_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(c_back, c_full.cpu().numpy()):
            failures.append("a checkpoint did not load back bit-equal")
        # 4. main on the same mesh, from inside a temporary directory.
        prefix = os.path.join(tmp, "delaunay.1.")
        write_tetgen(prefix, ctx["points"], ctx["tris"])
        main_dir = os.path.join(tmp, "main")
        os.makedirs(main_dir)
        cwd = os.getcwd()
        os.chdir(main_dir)
        try:
            t0 = time.perf_counter()
            c_main = ch_main(prefix, num_steps=MAIN_STEPS, device=dev)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        main_files = sorted(os.listdir(main_dir))
        if len(main_files) != MAIN_STEPS or not torch.isfinite(c_main).all():
            failures.append(f"main wrote {len(main_files)} snapshots, not {MAIN_STEPS}")
        # 5. a trace with an annotated region around two CH steps.
        in_region, attempts = [], 0
        for attempts in range(1, 4):
            tdir = os.path.join(tmp, f"trace{attempts}")
            with trace(tdir):
                with annotate("stormx-ch-steps"):
                    c = c0
                    for _ in range(2):
                        c, _ = step(c)
                    torch.cuda.synchronize()
            in_region = trace_kernels_in(tdir, "stormx-ch-steps")
            ours = {k: [n for n in in_region if k in n]
                    for k in ("sell_spmv_kernel", "banded_gather_kernel")}
            if all(ours.values()):
                break
        else:
            failures.append(f"the annotated region held {len(in_region)} kernels, "
                            f"not K1 and K3: {ours}")
    io_launches = dict(sell_spmv=sell_spmv.launches, banded_gather=banded_gather.launches)
    if not (io_launches["sell_spmv"] > 0 and io_launches["banded_gather"] > 0):
        failures.append(f"K1 and K3 must run in the io phase: {io_launches}")

    # 6. checked catches an out-of-range gather on the card before it runs.
    x = torch.arange(16, dtype=f32, device=dev)
    bad = torch.tensor([0, 3, 16], device=dev)
    err, out = checked(lambda v: v[bad])(x)
    err2, _ = checked(lambda v: torch.index_select(v, 0, bad))(x)
    caught = (err.get() or "", err2.get() or "")
    if not all("out-of-bounds" in m for m in caught):
        failures.append(f"checked missed the out-of-range gather: {caught}")
    plan = dmesh.bg_face_inner
    g = banded_gather.banded_gather_cuda(plan, c_full)
    after_ok = bool(torch.equal(g, banded_gather.banded_gather_plain(plan, c_full)))
    torch.cuda.synchronize()
    if not after_ok:
        failures.append("K3 after the checked gather differs from its plain version")

    # 7. segment_sum is deterministic on the card; index_add_ is timed beside it.
    sgen = torch.Generator(device="cpu").manual_seed(23)
    data = torch.randn(SEGMENT_ROWS, generator=sgen, dtype=f32).to(dev)
    ids = torch.randint(0, SEGMENT_COUNT, (SEGMENT_ROWS,), generator=sgen).to(dev)
    try:
        assert_deterministic(segment_sum, data, ids, SEGMENT_COUNT, runs=5)
        seg_det = True
    except AssertionError as e:
        seg_det = False
        failures.append(f"segment_sum is not deterministic: {e}")
    ref = torch.zeros(SEGMENT_COUNT, dtype=torch.float64, device=dev).index_add_(0, ids, data.double())
    seg_gap = float((segment_sum(data, ids, SEGMENT_COUNT).double() - ref).abs().max())
    adds = {torch.zeros(SEGMENT_COUNT, dtype=f32, device=dev).index_add_(0, ids, data)
            .cpu().numpy().tobytes() for _ in range(5)}
    emit("io", cells=mesh.num_cells, steps=IO_STEPS, output_every=IO_EVERY,
         snapshots=snaps, vtk_header=heads, resume_bit_equal=resume_equal,
         step_deterministic=step_deterministic,
         host_build_s=build_s, run_with_side_channels_s=run_side_s, resume_s=resume_s,
         first_step_ms=statistics.mean(step_ms),
         # run()'s ms per step with its side channels (its host build taken
         # out), and without them: less the snapshots and checkpoints it wrote.
         ch_ms_per_step_with=(run_side_s - build_s) * 1e3 / IO_STEPS,
         ch_ms_per_step_without=(run_side_s - build_s - len(snaps) * snapshot_s
                                 - len(snaps) * save_ms / 1e3) * 1e3 / IO_STEPS,
         seconds_per_snapshot=snapshot_s, checkpoint_save_ms=save_ms, checkpoint_load_ms=load_ms,
         main_s=main_s, main_snapshots=len(main_files),
         trace_attempts=attempts, kernels_in_annotated_region=len(in_region),
         ours_in_annotated_region=ours,
         checked=list(caught), kernel_after_checked_ok=after_ok,
         segment_sum=dict(rows=SEGMENT_ROWS, segments=SEGMENT_COUNT, deterministic=seg_det,
                          max_abs_gap_to_float64=seg_gap,
                          ms=time_ms(torch, lambda: segment_sum(data, ids, SEGMENT_COUNT)),
                          index_add_ms=time_ms(torch, lambda: torch.zeros(
                              SEGMENT_COUNT, dtype=f32, device=dev).index_add_(0, ids, data)),
                          index_add_distinct_results_in_5=len(adds)),
         launches=io_launches, failures=failures)
    require(not failures, "; ".join(failures))
    return io_launches


def single_rank_mesh(torch, dev):
    """World size 1 under NCCL on the card: a real NCCL group whose
    collectives launch on the card (its store lives in memory, no port)."""
    import torch.distributed as dist

    from stormx_torch.parallel import make_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=dev)
    return make_device_mesh(1, device=dev)


def on_ranks(torch, dev, pool, parts: int, fn, *args) -> list:
    """fn(mesh, *args) on every rank: P = 1 in this process under NCCL, else
    on the ``pool``'s process ranks, which share the card over gloo.
    Returns the ranks' results."""
    if parts == 1:
        return [fn(single_rank_mesh(torch, dev), *args)]
    require(pool.num_parts == parts, f"the rank pool has {pool.num_parts} ranks, not {parts}")
    return pool.run(fn, *args)


def _precond_of(mesh, pop, spec):
    """A preconditioner from its description: built on the rank, so the
    description crosses the process boundary and the object does not."""
    import torch

    from stormx_torch.parallel import DistributedAmg
    from stormx_torch.precond import ChebyshevPreconditioner, KrylovPreconditioner

    if spec is None:
        return {}
    kind, kw = spec
    if kind == "amg":
        kw = dict(kw)
        csr = kw.pop("csr")
        return {"amg": DistributedAmg(csr, pop, dtype=torch.float32, device=mesh.device, **kw)}
    if kind == "chebyshev":
        return {"precond": ChebyshevPreconditioner(**kw)}
    if kind == "krylov":
        return {"precond": KrylovPreconditioner(**kw)}
    return {kind: kw}  # "precond_diag" or "ras"


def par_solve(mesh, solver: str, op, b, kw: dict, spec=None) -> dict:
    """One rank's solve of phases 24-25 (module level: the rank pool
    pickles it).  K1's count is set to 0 just before the solve and read
    just after; the solve is timed on the host from a collective barrier to
    a synchronise.  Host results only; x from rank 0."""
    import torch

    from stormx_torch import parallel
    from stormx_torch.ops import sell_spmv

    extra = _precond_of(mesh, op, spec)
    mesh.all_reduce_sum(torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()
    mesh.calls.clear()
    sell_spmv.launches = 0
    t0 = time.perf_counter()
    res = getattr(parallel, solver)(op, b, mesh=mesh, **kw, **extra)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(iterations=res.num_iterations, converged=res.converged, s=seconds,
                calls=dict(mesh.calls), backend=mesh.backend, k1=sell_spmv.launches,
                history=None if res.history is None else res.history.cpu().numpy(),
                x=res.x.cpu().numpy() if mesh.rank == 0 else None)


def par_matvec(mesh, pop, xp):
    """``sharded_matvec`` on one rank; the whole layout from rank 0."""
    from stormx_torch.parallel import sharded_matvec

    y = sharded_matvec(pop, mesh)(xp)
    return y.cpu() if mesh.rank == 0 else None


def host_csr(csr, dtype):
    """A host CSR with its values cast to the NumPy ``dtype``."""
    from stormx_torch.sparse.formats import CSR, host

    return CSR(data=host(csr.data).astype(dtype), indices=host(csr.indices).astype(np.int32),
               row_ptr=host(csr.row_ptr).astype(np.int32), shape=tuple(csr.shape))


def diffusion_csr(mesh, lap):
    """V + τ·L of phase 20 in the mesh's own numbering, float64 on the
    host: L the two-point-flux Laplacian, V the cell volumes."""
    from stormx_torch.sparse.formats import CSR, host

    rp, idx = host(lap.row_ptr), host(lap.indices)
    rows = np.repeat(np.arange(mesh.num_cells), np.diff(rp))
    data = DIFFUSION_TAU * host(lap.data).astype(np.float64) + np.where(
        idx == rows, mesh.cell_volumes[rows], 0.0)
    return CSR(data=data, indices=idx.astype(np.int32), row_ptr=rp.astype(np.int32),
               shape=tuple(lap.shape))


def csr_diag(csr) -> np.ndarray:
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.row_ptr))
    d = np.zeros(csr.shape[0], dtype=csr.data.dtype)
    d[rows[csr.indices == rows]] = csr.data[csr.indices == rows]
    return d


def history_gaps(h_ref: np.ndarray, h: np.ndarray) -> dict:
    """Relative gaps of two equal-length histories: the largest, at a few
    iterations, and the first iteration past 1e-8."""
    gap = np.abs(h - h_ref) / h_ref
    at = [k for k in (10, 50, 100, 200, 400, 600, 800) if k < len(gap)]
    past = np.nonzero(gap > 1e-8)[0]
    return dict(max=float(gap.max()), at={k: float(gap[k]) for k in at},
                first_past_1e_8=int(past[0]) if len(past) else None)


def run_parallel(torch, dev, ctx: dict, pool) -> dict:
    """Phase 24, the distributed CSR and SlicedELL solves on phase 2's mesh,
    float32 on the card, at P = 1 (NCCL, in this process) and P =
    ``PAR_PARTS`` (``pool``'s process ranks sharing the card over gloo).
    Returns K1's entry on a slab operator, with the phase's slab launches."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import build_mesh
    from stormx_torch.ops import sell_spmv
    from stormx_torch.parallel import (partition_csr, partition_sliced, partition_vector,
                                       unpartition_vector)
    from stormx_torch.precond import JacobiPreconditioner
    from stormx_torch.solvers import SolverOptions, cg, make_operator
    from stormx_torch.sparse.windowed import SlicedELL

    f32, f64 = torch.float32, torch.float64
    cpu = torch.device("cpu")
    mesh = ctx["mesh"]
    n = mesh.num_cells
    h64 = diffusion_csr(mesh, ctx["laplacian"].to_csr())
    h32 = host_csr(h64, np.float32)
    ell64 = device_ell(torch, h64, f64, dev)
    b64 = np.random.default_rng(0).standard_normal(n)
    b32 = b64.astype(np.float32)
    b64_dev = torch.as_tensor(b64, device=dev)
    diag32, diag64 = csr_diag(h32), csr_diag(h64)
    opts = SolverOptions(num_iterations=PRECOND_MAX_ITERATIONS, absolute_tolerance=0.0,
                         relative_tolerance=PRECOND_RTOL["diffusion"], record_history=False)
    gate = PRECOND_TRUE_RES["diffusion"]
    parts = (1, PAR_PARTS)
    cases, failures, host_s = [], [], {}
    k1_path = 0

    def timed_host(key, build):
        t0 = time.perf_counter()
        out = build()
        host_s[key] = time.perf_counter() - t0
        return out

    def run_case(name, p, solver, op, b, kw, spec=None, *, ref=ell64, b_ref=b64_dev, **extra):
        """One solve on p ranks: every rank's iterations the same, converged,
        and its float64 true residual under ``gate``."""
        nonlocal k1_path
        outs = on_ranks(torch, dev, pool, p, par_solve, solver, op, b, kw, spec)
        its = [o["iterations"] for o in outs]
        it = max(its[0], 1)
        seconds = max(o["s"] for o in outs)
        k1 = sum(o["k1"] for o in outs)
        k1_path += k1
        x = torch.as_tensor(outs[0]["x"], device=dev).double()
        r = b_ref - ref.matvec(x)
        tr = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b_ref))
        case = dict(name=name, parts=p, backend=outs[0]["backend"], iterations=its[0],
                    converged=outs[0]["converged"], ms=1e3 * seconds,
                    ms_per_iteration=1e3 * seconds / it,
                    collectives_per_iteration={k: v / it for k, v in outs[0]["calls"].items()},
                    k1_launches=k1, k1_launches_per_rank_per_iteration=k1 / (p * it),
                    true_relative_residual=tr, **extra)
        if len(set(its)) != 1:
            failures.append(f"{name} P={p}: ranks took {its} iterations")
        if not outs[0]["converged"]:
            failures.append(f"{name} P={p}: did not converge in {its[0]} iterations")
        if tr > gate:
            failures.append(f"{name} P={p}: true residual {tr} > {gate}")
        cases.append(case)
        return case, outs

    def same_iterations(name, a, b_):
        gap = PAR_ITERATION_GAP_BY_CASE.get(name, PAR_ITERATION_GAP)
        if abs(a["iterations"] - b_["iterations"]) > gap * a["iterations"]:
            failures.append(f"{name}: {a['iterations']} iterations at P={a['parts']}, "
                            f"{b_['iterations']} at P={b_['parts']}")

    # -- the partitions (host; each rank moves its slab to the card) ----------------
    pops = {(m, p): timed_host(f"partition_csr/{m}/P{p}",
                               lambda m=m, p=p: partition_csr(h32, p, method=m, device=cpu))
            for m in ("rcm-blocks", "bfs") for p in parts}
    sliced = {p: timed_host(f"partition_sliced/pallas/P{p}",
                            lambda p=p: partition_sliced(h32, p, mode="pallas", device=cpu))
              for p in parts}
    require(all(ps.mode == "pallas" and ps.block_rows == 512 for ps in sliced.values()),
            "partition_sliced did not take K1 at R = 512")
    auto = partition_sliced(h32, PAR_PARTS, device=dev)
    require(auto.mode == "pallas", f"mode 'auto' chose {auto.mode!r} for float32 on the card")
    del auto

    # -- K1 on a slab operator, against its plain version ---------------------------
    ps = sliced[PAR_PARTS]
    R, C = ps.block_rows, ps.window
    rank = 1  # an inner rank: both halos live
    slab = SlicedELL(data=ps.ell_data[rank].to(dev), local_cols=ps.ell_cols[rank].to(dev),
                     shape=(ps.n_loc, ps.n_loc + C - R), window=C, pad_lo=0, mode="cuda",
                     dense_blocks=None)
    gen = torch.Generator(device="cpu").manual_seed(24)
    x_ext = torch.randn(slab.shape[1], generator=gen, dtype=f32).to(dev)
    y_k, y_p = sell_spmv.sell_spmv_cuda(slab, x_ext), sell_spmv.sell_spmv_plain(slab, x_ext)
    torch.cuda.synchronize()
    k1_err, k1_scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
    require(k1_err <= 1e-5 * k1_scale, f"K1 on a slab: {k1_err} > 1e-5·{k1_scale}")
    bl_lo, bl_hi = -(-ps.h_lo // R), (ps.n_loc - C + ps.h_lo) // R + 1
    require(bl_hi > bl_lo, f"rank {rank}'s slab has no interior block range")
    inner = SlicedELL(data=slab.data[bl_lo:bl_hi], local_cols=slab.local_cols[bl_lo:bl_hi],
                      shape=((bl_hi - bl_lo) * R, slab.shape[1] - bl_lo * R), window=C, pad_lo=0,
                      mode="cuda", dense_blocks=None)
    x_in = x_ext[bl_lo * R:]
    yi_k, yi_p = sell_spmv.sell_spmv_cuda(inner, x_in), sell_spmv.sell_spmv_plain(inner, x_in)
    torch.cuda.synchronize()
    in_err = float((yi_k - yi_p).abs().max())
    require(in_err <= 1e-5 * float(yi_p.abs().max()), f"K1 on a block range: {in_err}")
    slab_csr = sell_to_csr(slab)
    a_csr, nnz = torch_csr(torch, slab_csr, dev), int(slab_csr.nnz)
    b_ms, b_by = bound_ms(8.0 * nnz + 4.0 * (slab.shape[0] + slab.shape[1]), 2.0 * nnz)
    k1_entry = dict(
        name="sell_spmv/parallel", route="cuda", source="stormx_torch/csrc/sell_spmv.cu",
        replaces="stormx/ops/pallas_sell.py:64",
        tpu_source="stormx/ops/pallas_sell.py:_kernel via stormx/parallel/sliced.py:105",
        shape=dict(rows=slab.shape[0], cols=slab.shape[1], nnz=nnz, K=slab.data.shape[1], R=R,
                   window=C, operator="diffusion, rank 1 of 4, extended slab"),
        ok=True, max_abs_err=k1_err, max_err=k1_err, max_abs_y=k1_scale,
        block_range=dict(blocks=[bl_lo, bl_hi], max_abs_err=in_err),
        ms=time_ms(torch, lambda: sell_spmv.sell_spmv_cuda(slab, x_ext)),
        plain_ms=time_ms(torch, lambda: sell_spmv.sell_spmv_plain(slab, x_ext)),
        library_ms=time_ms(torch, lambda: a_csr @ x_ext),
        library_call="torch.sparse_csr_tensor @ x", bound_ms=b_ms, bound_by=b_by)
    del a_csr, y_k, y_p, yi_k, yi_p, slab, inner

    # -- sharded_matvec against the serial product -------------------------------
    x64 = torch.randn(n, generator=gen, dtype=f64)
    y64 = ell64.matvec(x64.to(dev)).cpu()
    mv_err = {}
    for p in parts:
        pop = pops[("rcm-blocks", p)]
        y = unpartition_vector(pop, on_ranks(torch, dev, pool, p, par_matvec, pop,
                                             partition_vector(pop, x64.float()))[0]).double()
        mv_err[p] = float((y - y64).abs().max() / y64.abs().max())
        if mv_err[p] > PAR_MATVEC:
            failures.append(f"sharded_matvec P={p}: {mv_err[p]} > {PAR_MATVEC} of max|y|")

    # -- the path: each rank's K1 count at 0 just before its solve ------------------
    jacobi = ("precond_diag", diag32)
    by = {}
    for m in ("rcm-blocks", "bfs"):
        for p in parts:
            pop = pops[(m, p)]
            by[("cg_jacobi", m, p)], _ = run_case(
                f"cg_jacobi/{m}", p, "sharded_solve", pop, b32, dict(method="cg", options=opts),
                jacobi, n_pad=pop.n_pad, s_max=pop.s_max, boundary_rows=int(pop.bnd_idx.shape[1]))
        same_iterations(f"cg_jacobi/{m}", by[("cg_jacobi", m, 1)], by[("cg_jacobi", m, PAR_PARTS)])

    for p in parts:
        ps = sliced[p]
        per_product = 3 if ((ps.n_loc - C + ps.h_lo) // R + 1) > -(-ps.h_lo // R) else 1
        case, _ = run_case("sliced_cg/pallas", p, "sharded_sliced_solve", ps, b32,
                           dict(method="cg", options=opts), jacobi, n_loc=ps.n_loc, window=C,
                           halo=[ps.h_lo, ps.h_hi], k1_per_product=per_product)
        by[("sliced", p)] = case
        want = p * per_product * (case["iterations"] + 1)
        if case["k1_launches"] != want:
            failures.append(f"sliced_cg/pallas P={p}: {case['k1_launches']} K1 launches, not "
                            f"{want} ({per_product} per slab product)")
    same_iterations("sliced_cg/pallas", by[("sliced", 1)], by[("sliced", PAR_PARTS)])
    slab_launches = sum(by[("sliced", p)]["k1_launches"] for p in parts)
    if not slab_launches:
        failures.append("K1 was not launched on a slab in the parallel phase")

    # The dense-window mode once at P = 1, if its (nb, R, C) windows fit.
    perm = sliced[1].perm
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows = np.repeat(np.arange(n), np.diff(h32.row_ptr))
    d = inv[h32.indices] - inv[rows]
    c128 = -(-(int(-d.min()) + 128 + int(d.max())) // 128) * 128
    dense_bytes = -(-n // 128) * 128 * c128 * 4
    dense = dict(window=c128, bytes=dense_bytes, cap=PAR_DENSE_BYTES)
    if dense_bytes <= PAR_DENSE_BYTES:
        psd = timed_host("partition_sliced/dense/P1",
                         lambda: partition_sliced(h32, 1, mode="dense", device=cpu))
        case, _ = run_case("sliced_cg/dense", 1, "sharded_sliced_solve", psd, b32,
                           dict(method="cg", options=opts), jacobi)
        same_iterations("sliced_cg dense/pallas", by[("sliced", 1)], case)
        del psd
    else:
        dense["skipped"] = f"{dense_bytes} bytes of windows > {PAR_DENSE_BYTES}"

    # CG + DistributedAmg (built on each rank); CG + Chebyshev (Gershgorin's
    # λmax); FGMRES + Krylov (CG 8).
    lmax = float(np.max(np.bincount(rows, weights=np.abs(h64.data), minlength=n)))
    for p in parts:
        pop = pops[("rcm-blocks", p)]
        by[("amg", p)], _ = run_case(
            "cg_amg", p, "sharded_solve", pop, b32, dict(method="cg", options=opts),
            ("amg", dict(csr=h64, num_sweeps=PRECOND_AMG_SWEEPS)))
        by[("cheb", p)], _ = run_case(
            "cg_chebyshev", p, "sharded_solve", pop, b32, dict(method="cg", options=opts),
            ("chebyshev", dict(degree=PRECOND_CHEB_DEGREE, lambda_max=lmax)),
            lambda_max=lmax, degree=PRECOND_CHEB_DEGREE)
        by[("krylov", p)], _ = run_case(
            "fgmres_krylov", p, "sharded_solve", pop, b32, dict(method="fgmres", options=opts),
            ("krylov", dict(method="cg", num_iterations=PRECOND_KRYLOV_INNER)),
            inner_iterations=PRECOND_KRYLOV_INNER)
    for key in ("amg", "cheb", "krylov"):
        same_iterations(key, by[(key, 1)], by[(key, PAR_PARTS)])
    for p in parts:
        if not by[("amg", p)]["k1_launches"]:
            failures.append(f"cg_amg P={p}: the coarse V-cycle did not launch K1")

    # BiCGStab + RAS-ILU(0) on the smaller mesh; its iterations grow with P.
    small = timed_host("ras_mesh", lambda: build_mesh(
        *delaunay_mesh(PAR_RAS_SIDE, JITTER, seed=0)).optimize_ordering())
    s64 = diffusion_csr(small, assemble_laplacian(small).to_csr())
    s32 = host_csr(s64, np.float32)
    s_ell = device_ell(torch, s64, f64, dev)
    sb64 = np.random.default_rng(0).standard_normal(small.num_cells)
    sb_dev = torch.as_tensor(sb64, device=dev)
    for p in parts:
        pop = timed_host(f"partition_csr/ras/P{p}", lambda p=p: partition_csr(s32, p, device=cpu))
        by[("ras", p)], _ = run_case(
            "bicgstab_ras_ilu0", p, "sharded_solve", pop, sb64.astype(np.float32),
            dict(method="bicgstab", options=opts), ("ras", "ilu0"), ref=s_ell, b_ref=sb_dev,
            cells=small.num_cells)

    # float64 CG + Jacobi at P = 1 and P = PAR_PARTS (equal iterations,
    # histories within PAR_F64_HISTORY), beside the serial float64 CG.
    opts64 = SolverOptions(num_iterations=PRECOND_MAX_ITERATIONS, absolute_tolerance=0.0,
                           relative_tolerance=PRECOND_RTOL["diffusion"])
    hist = {}
    for p in parts:
        pop = timed_host(f"partition_csr/f64/P{p}", lambda p=p: partition_csr(h64, p, device=cpu))
        case, outs = run_case("cg_jacobi/float64", p, "sharded_solve", pop, b64,
                              dict(method="cg", options=opts64), ("precond_diag", diag64))
        hist[p] = outs[0]["history"][: case["iterations"] + 1]
    serial = cg(make_operator(ell64.matvec), b64_dev, torch.zeros_like(b64_dev),
                precond=JacobiPreconditioner(diag=torch.as_tensor(diag64, device=dev)),
                options=opts64)
    h_serial = serial.history[: serial.num_iterations + 1].cpu().numpy()
    h1, h4 = hist[1], hist[PAR_PARTS]
    f64 = dict(iterations={1: len(h1) - 1, PAR_PARTS: len(h4) - 1,
                           "serial": serial.num_iterations})
    if len(h1) != len(h4):
        failures.append(f"float64 CG + Jacobi: {len(h1) - 1} iterations at P=1, "
                        f"{len(h4) - 1} at P={PAR_PARTS}")
    else:
        f64["P1_P4"] = history_gaps(h1, h4)
        early = f64["P1_P4"]["first_past_1e_8"]
        if early is not None and early <= PAR_F64_EXACT:
            failures.append(f"float64 CG + Jacobi histories part by 1e-8 at iteration {early}"
                            f" (≤ {PAR_F64_EXACT})")
        if f64["P1_P4"]["max"] > PAR_F64_HISTORY:
            failures.append(f"float64 CG + Jacobi histories differ by {f64['P1_P4']['max']} "
                            f"> {PAR_F64_HISTORY}")
    if len(h_serial) == len(h1):
        f64["serial_P1"] = history_gaps(h_serial, h1)

    k1_entry["launches"] = slab_launches
    k1_entry["kernel_ms"] = k1_entry["ms"]
    emit("parallel", cells=n, parts=list(parts), rtol=PRECOND_RTOL["diffusion"],
         true_residual_gate=gate, host_s=host_s, sharded_matvec_rel_err=mv_err, dense=dense,
         ras_cells=small.num_cells, cases=cases, float64=f64,
         k1_launches=k1_path, k1_slab_launches=slab_launches, failures=failures)
    require(not failures, "; ".join(failures))
    return k1_entry


def run_parallel_banded(torch, dev, nx: int, serial: dict, pool) -> None:
    """Phase 25, ``sharded_dia_solve`` CG on phase 7's 2048² Poisson operator
    at P = 1 (NCCL) and P = ``PAR_PARTS`` (``pool``'s process ranks), held
    to phase 8's serial banded CG (``serial``: its iterations)."""
    import torch.distributed as dist

    from stormx_torch.parallel import partition_dia
    from stormx_torch.solvers import SolverOptions
    from stormx_torch.sparse.formats import DIA

    offsets, data = poisson5_diags(nx)
    n = nx * nx
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    opts = SolverOptions(num_iterations=CG_MAX_ITERATIONS, absolute_tolerance=0.0,
                         relative_tolerance=BANDED_RTOL, record_history=False)
    op_dev = DIA(data=torch.as_tensor(data, device=dev), offsets=offsets, shape=(n, n))
    b_dev = torch.as_tensor(b, device=dev)
    runs, failures = [], []
    for p in (1, PAR_PARTS):
        t0 = time.perf_counter()
        pdia = partition_dia(DIA(data=data, offsets=offsets, shape=(n, n)), p,
                             device=torch.device("cpu"))
        host_s = time.perf_counter() - t0
        outs = on_ranks(torch, dev, pool, p, par_solve, "sharded_dia_solve", pdia, b,
                        dict(method="cg", options=opts))
        its = [o["iterations"] for o in outs]
        it = max(its[0], 1)
        seconds = max(o["s"] for o in outs)
        tr = true_residual(torch, op_dev, torch.as_tensor(outs[0]["x"], device=dev), b_dev)
        runs.append(dict(parts=p, backend=outs[0]["backend"], iterations=its[0],
                         converged=outs[0]["converged"], ms=1e3 * seconds,
                         ms_per_iteration=1e3 * seconds / it, host_s=host_s,
                         collectives_per_iteration={k: v / it for k, v in outs[0]["calls"].items()},
                         n_loc=pdia.n_loc, halo=pdia.h,
                         shift_bytes_per_link_per_product=2 * pdia.h * 4 if p > 1 else 0,
                         true_relative_residual=tr))
        if len(set(its)) != 1:
            failures.append(f"P={p}: ranks took {its} iterations")
        if not outs[0]["converged"]:
            failures.append(f"P={p}: did not converge in {its[0]} iterations")
        if abs(its[0] - serial["iterations"]) > PAR_ITERATION_GAP * serial["iterations"]:
            failures.append(f"P={p}: {its[0]} iterations against phase 8's {serial['iterations']}")
        if tr > BANDED_CG_TRUE_RES:
            failures.append(f"P={p}: true residual {tr} > {BANDED_CG_TRUE_RES}")
        del pdia, outs
    emit("parallel_banded", rows=n, relative_tolerance=BANDED_RTOL,
         true_residual_gate=BANDED_CG_TRUE_RES, serial=serial, runs=runs, failures=failures)
    if dist.is_initialized():
        dist.destroy_process_group()
    require(not failures, "; ".join(failures))


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
    banded_ctx = {}
    banded = run_banded(torch, dev, NX, FVM_SIDE, banded_ctx)
    k2a = next(e for e in banded if e["name"] == "dia_spmv")
    kernels = out["kernels"] + banded + run_packed(torch, dev, out["packed_ctx"], k2a)
    kernels += run_fvm(torch, dev, out["packed_ctx"])
    kernels.append(run_precond(torch, dev, out["packed_ctx"]))
    run_lsq(torch, dev, out["packed_ctx"])
    kernels += run_complex(torch, dev, out["packed_ctx"])
    run_io(torch, dev, out["packed_ctx"])
    from stormx_torch.parallel.comm import RankPool

    with RankPool(PAR_PARTS, device=dev, timeout=PAR_TIMEOUT) as pool:
        kernels.append(run_parallel(torch, dev, out["packed_ctx"], pool))
        run_parallel_banded(torch, dev, NX, banded_ctx["banded_cg"], pool)
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
