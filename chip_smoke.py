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
   1e-5·max|y|), K3 on the four mesh gather plans (bit-exact) — with CUDA
   event timings (median of 30 after warm-up) beside one library call.
4. ``app``: three assembled Cahn–Hilliard steps in float32 on the card
   (through ``make_assembled_step`` and again through ``run``), step 1 held
   against the port on the CPU in float64 (within ``CH_GAP``, CG
   iterations within 10%), plus one matrix-free step.
5. ``poisson``: Milestone A — CG + Jacobi on the two-point-flux Laplacian
   of the same mesh, float32, to a relative tolerance of ``POISSON_RTOL``,
   and the same solve on the CPU in float64 to 1e-8.
6. ``profile``: a ``torch.profiler`` trace of 200 iterations of that CG:
   the device-busy share and the kernel time by name.

The launch counters are set to 0 just before each of phases 4 and 5 and
read just after; both kernels must have run in the app phase, K1 in the
Poisson phase.  Then come the ``{"kernels": [...]}`` line, the
``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.
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


def sell_to_torch_csr(torch, op):
    """The SlicedELL operator as a torch CSR tensor (the library yardstick)."""
    nb, K, R = op.data.shape
    b = torch.arange(nb, device=op.data.device)[:, None, None]
    r = torch.arange(R, device=op.data.device)[None, None, :]
    rows = (b * R + r).expand(nb, K, R)
    cols = b * R - op.pad_lo + op.local_cols.long()
    live = op.data != 0
    idx = torch.stack([rows[live], cols[live]])
    coo = torch.sparse_coo_tensor(idx, op.data[live], op.shape).coalesce()
    return coo.to_sparse_csr(), int(live.sum())


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
    a_csr, nnz = sell_to_torch_csr(torch, op)
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
        b_ms, b_by = bound_ms(4.0 * plan.m + 4.0 * plan.n_src + 4.0 * plan.m, 0.0)
        kernels.append(dict(
            name=f"banded_gather/{name}", route="cuda",
            source="stormx_torch/csrc/banded_gather.cu",
            replaces="stormx/ops/pallas_gather.py:40",
            tpu_source="stormx/ops/pallas_gather.py:_kernel",
            shape=dict(m=plan.m, n_src=plan.n_src, window=plan.window,
                       fixups=int(plan.fix_pos.numel())),
            ok=True, max_abs_err=g_err, max_err=g_err,
            ms=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, xg)),
            ms_l2_flushed=time_ms(torch, lambda: banded_gather.banded_gather_cuda(plan, xg),
                                  flush=flush),
            plain_ms=time_ms(torch, lambda: banded_gather.banded_gather_plain(plan, xg)),
            library_ms=time_ms(torch, lambda: torch.index_select(xg, 0, idx)),
            library_call="torch.index_select(x, 0, idx)",
            bound_ms=b_ms, bound_by=b_by,
        ))
    del flush
    emit("kernel_check", kernels=[{k: v for k, v in e.items()} for e in kernels])

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
    return dict(kernels=kernels, smi=smi)


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
    print(json.dumps({"kernels": out["kernels"]}), flush=True)
    print(out["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
