#!/usr/bin/env python3
"""What the FVM path's reference settings do at the smoke's sizes, on the CPU.

    python3 scripts/torch_fvm_study.py leak SIDE         # Euler march: slip-wall mass/energy drift
    python3 scripts/torch_fvm_study.py convdiff SIDE     # float32 vs float64 BiCGStab, and refinement
    python3 scripts/torch_fvm_study.py implicit SIDE CFL # JFNK implicit step at a CFL number
    python3 scripts/torch_fvm_study.py projection SIDE   # NS projection CG: Delaunay vs structured
    python3 scripts/torch_fvm_study.py tetplans N ...    # K3 plans of structured_tet_box(N, N, N)

Each part prints JSON lines.  The Delaunay meshes are ``chip_smoke.py``'s
jittered grid at ``SIDE`` points a side (SIDE = 400 is the smoke's mesh: run
that size on a machine with the memory for it); every part runs on the CPU,
float64 unless it says otherwise, and the gathers take K3's plain version.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def delaunay(side: int):
    from stormx_torch.mesh import read_tetgen

    pts, tris = chip_smoke.delaunay_mesh(side, chip_smoke.JITTER, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_tetgen(os.path.join(tmp, "d.1."), pts, tris)
        return read_tetgen(os.path.join(tmp, "d.1.")).optimize_ordering()


def part_leak(torch, side: int) -> None:
    """The smoke's march (order 2, slip walls, the Riemann state) in float64
    and float32: Σ ρ·V and Σ ρE·V against the start, at steps 5 to 200."""
    from stormx_torch.fvm import FvSolver, slip_bc

    mesh = delaunay(side)
    dt = chip_smoke.cfl_dt(mesh, float(np.sqrt(1.4)))
    for dtype in (torch.float64, torch.float32):
        dm = mesh.device_arrays(dtype, device="cpu")
        u0 = chip_smoke.riemann_state(torch, mesh.cell_centers, dtype, "cpu")
        solver = FvSolver(dm, bcs={1: slip_bc})
        m0, e0 = chip_smoke.gas_totals(torch, dm, u0)
        u = u0
        for k in range(1, 201):
            u = solver.step(u, dt)
            if k in (5, 20, 50, 100, 200):
                m, e = chip_smoke.gas_totals(torch, dm, u)
                emit(part="leak", side=side, cells=mesh.num_cells, dtype=str(dtype), step=k,
                     mass_drift=(m - m0) / m0, energy_drift=(e - e0) / e0)


def part_convdiff(torch, side: int) -> None:
    """BASELINE config #2 on the Delaunay mesh: BiCGStab + Jacobi to 1e-5 in
    float32 and float64 (true residuals in float64 through the CSR), and the
    smoke's float64 refinement around capped float32 solves."""
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.precond import JacobiPreconditioner
    from stormx_torch.solvers import SolverOptions, bicgstab, make_operator
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import auto_operator

    mesh = delaunay(side)
    ell = assemble_convection_diffusion(mesh, chip_smoke.rotating_velocity,
                                        chip_smoke.CONVDIFF_EPS)
    csr = ell.to_csr()
    c = mesh.cell_centers
    rhs = np.sin(2 * np.pi * c[:, 0]) * np.cos(np.pi * c[:, 1]) + 0.1
    diag = ell.diagonal().numpy()

    def true_res(x):
        return float(np.linalg.norm(ell.matvec(torch.as_tensor(x)).numpy() - rhs)
                     / np.linalg.norm(rhs))

    for dtype in (torch.float32, torch.float64):
        op, perm = auto_operator(CSR(data=csr.data.to(dtype), indices=csr.indices,
                                     row_ptr=csr.row_ptr, shape=csr.shape),
                                 coords=c, device="cpu")
        jac = JacobiPreconditioner(diag=torch.as_tensor(diag[perm], dtype=dtype))

        def solve(r, rtol, cap):
            b = torch.as_tensor(r[perm], dtype=dtype)
            res = bicgstab(make_operator(op.matvec), b, torch.zeros_like(b), precond=jac,
                           options=SolverOptions(num_iterations=cap, absolute_tolerance=0.0,
                                                 relative_tolerance=rtol))
            x = np.empty(len(r))
            x[perm] = res.x.double().numpy()
            return x, res

        t0 = time.perf_counter()
        x, res = solve(rhs, chip_smoke.CONVDIFF_RTOL, 4_000)
        h = res.history.double().numpy()
        h = h[np.isfinite(h)]
        emit(part="convdiff", side=side, cells=mesh.num_cells, dtype=str(dtype),
             iterations=res.num_iterations, converged=res.converged,
             true_relative_residual=true_res(x), hump=float(h.max() / h[0]),
             seconds=time.perf_counter() - t0)
        if dtype == torch.float32:
            x = np.zeros(len(rhs))
            hist = [true_res(x)]
            while hist[-1] > chip_smoke.CONVDIFF_RTOL and len(hist) <= chip_smoke.CONVDIFF_OUTER_CAP:
                r = rhs - ell.matvec(torch.as_tensor(x)).numpy()
                scale = float(np.linalg.norm(r))
                d, _ = solve(r / scale, chip_smoke.CONVDIFF_INNER_RTOL,
                             chip_smoke.CONVDIFF_INNER_CAP)
                x += scale * d
                hist.append(true_res(x))
            emit(part="convdiff_refined", side=side, outer_steps=len(hist) - 1,
                 true_relative_residual=hist)


def part_implicit(torch, side: int, cfl: float) -> None:
    """One float64 implicit step (JFNK) of the smoke's smooth state at the
    given CFL number on the smallest cell: Newton iterations, operator
    applications, the residual history."""
    from stormx_torch.fvm import FvSolver, slip_bc

    mesh = delaunay(side)
    dt = chip_smoke.cfl_dt(mesh, float(np.sqrt(1.4))) * cfl / chip_smoke.EULER_CFL
    solver = FvSolver(mesh.device_arrays(torch.float64, device="cpu"), bcs={1: slip_bc})
    calls = [0]
    calc = solver.calc_func

    def counted(w):
        calls[0] += 1
        return calc(w)

    solver.calc_func = counted
    w0 = chip_smoke.smooth_state(torch, mesh.cell_centers, torch.float64, "cpu")
    t0 = time.perf_counter()
    res = solver.implicit_step(w0, dt)
    emit(part="implicit", side=side, cells=mesh.num_cells, cfl=cfl, dt=dt,
         converged=res.converged, newton_iterations=res.num_iterations,
         operator_applications=calls[0], seconds=time.perf_counter() - t0,
         history=[float(h) for h in res.history[: res.num_iterations + 1]])


def part_projection(torch, side: int) -> None:
    """One NS projection step with CG on the Delaunay mesh and on a
    structured mesh of the same side, float64 (rtol 1e-8) and float32 (rtol
    1e-4): CG iterations and the corrected face-flux divergence ratio."""
    from stormx_torch.apps.navier_stokes import NsProjection, cell_divergence, flux_divergence
    from stormx_torch.mesh import structured_tri_rect
    from stormx_torch.solvers import SolverOptions

    for name, mesh in (("delaunay", delaunay(side)),
                       ("structured", structured_tri_rect(side, side).optimize_ordering())):
        for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, 1e-4)):
            opts = SolverOptions(num_iterations=20_000, absolute_tolerance=0.0,
                                 relative_tolerance=rtol, record_history=False)
            ns = NsProjection(mesh, method="cg", solver_kw={"options": opts}, dtype=dtype,
                              device="cpu")
            vel0 = torch.as_tensor(chip_smoke.taylor_green(mesh.cell_centers), dtype=dtype)
            _, _, res, flux = ns.step(vel0, chip_smoke.NS_DT)
            df = flux_divergence(ns.dmesh, flux).double()
            d0 = cell_divergence(ns.dmesh, vel0).double()
            emit(part="projection", mesh=name, side=side, cells=mesh.num_cells,
                 dtype=str(dtype), cg_iterations=res.num_iterations, converged=res.converged,
                 divergence_ratio=float(torch.linalg.vector_norm(df - df.mean())
                                        / torch.linalg.vector_norm(d0)))


def part_tetplans(torch, sides) -> None:
    """Which K3 plans of structured_tet_box(N, N, N) are wider than
    MAX_CHUNKS windows (``xla_fallback``: the JAX plan gathers them plainly,
    K3 with the indices as its words), and their windows."""
    from stormx_torch.mesh import structured_tet_box

    for n in sides:
        m = structured_tet_box(n, n, n).optimize_ordering()
        dm = m.device_arrays(torch.float32, device="cpu", banded_gather=True)
        emit(part="tetplans", side=n, cells=m.num_cells, faces=m.num_faces,
             plans={name: dict(xla_fallback=getattr(dm, "bg_" + name).xla_fallback,
                               window=getattr(dm, "bg_" + name).window)
                    for name in ("face_inner", "face_outer", "cell_face", "cell_adj")})


def main() -> int:
    import torch

    part = sys.argv[1] if len(sys.argv) > 1 else ""
    args = [float(a) for a in sys.argv[2:]]
    if part == "leak" and len(args) == 1:
        part_leak(torch, int(args[0]))
    elif part == "convdiff" and len(args) == 1:
        part_convdiff(torch, int(args[0]))
    elif part == "implicit" and len(args) == 2:
        part_implicit(torch, int(args[0]), args[1])
    elif part == "projection" and len(args) == 1:
        part_projection(torch, int(args[0]))
    elif part == "tetplans" and args:
        part_tetplans(torch, [int(a) for a in args])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
