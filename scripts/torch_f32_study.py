#!/usr/bin/env python3
"""How far float32 CG gets on the stormx_torch main path, against float64.

    python3 scripts/torch_f32_study.py mesh      # CPU: uniform vs jittered Delaunay
    python3 scripts/torch_f32_study.py ch        # CUDA: Cahn–Hilliard steps at 318k/159k cells
    python3 scripts/torch_f32_study.py poisson   # CUDA: Milestone A at 318k cells

Each part prints JSON lines.  ``mesh`` runs on the CPU in float64 at ~6k
cells.  ``ch`` and ``poisson`` need a CUDA card: float32 runs through the
kernel mode, float64 through the onehot mode (the plain gather) on the same
card.  The meshes are those of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def history(res) -> np.ndarray:
    return res.history[: res.num_iterations + 1].double().cpu().numpy()


def first_below(h: np.ndarray, level: float) -> int:
    """First iteration whose residual is ≤ level, or -1."""
    hit = np.nonzero(h <= level)[0]
    return int(hit[0]) if len(hit) else -1


def part_mesh(torch) -> None:
    """Uniform random points against the jittered grid: smallest cell and
    whether CG on the CH operator converges in float64 (CPU, default options)."""
    from scipy.spatial import Delaunay

    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.mesh import build_mesh

    pts = np.random.default_rng(0).random((3000, 2))
    uniform = build_mesh(pts, Delaunay(pts).simplices)
    jittered = build_mesh(*chip_smoke.delaunay_mesh(55, chip_smoke.JITTER, seed=0))
    for name, mesh in (("uniform", uniform), ("jittered", jittered)):
        mesh = mesh.optimize_ordering()
        areas = np.sort(mesh.cell_volumes)
        step = make_assembled_step(mesh, dtype=torch.float64, device="cpu")
        c0 = 0.5 + 0.1 * np.random.default_rng(0).standard_normal(mesh.num_cells)
        _, res = step(torch.as_tensor(c0))
        emit(part="mesh", mesh=name, cells=mesh.num_cells, min_area=float(areas[0]),
             median_area=float(areas[len(areas) // 2]), cg_iterations=res.num_iterations,
             converged=res.converged, relative_error=float(res.relative_error))


def _mesh(side):
    from stormx_torch.mesh import build_mesh

    return build_mesh(*chip_smoke.delaunay_mesh(side, chip_smoke.JITTER, seed=0)).optimize_ordering()


def part_ch(torch, dev) -> None:
    """CH step 1 in float32 and float64 at rtol 1e-6 and 1e-8; the three-step
    march at rtol 1e-6 alone (no absolute tolerance)."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.solvers import SolverOptions

    dtypes = {"float32": torch.float32, "float64": torch.float64}
    for side, rtols in ((400, (1e-6, 1e-8)), (283, (1e-6,))):
        mesh = _mesh(side)
        c0 = 0.5 + 0.1 * np.random.default_rng(0).standard_normal(mesh.num_cells)
        for rtol in rtols:
            opts = SolverOptions(num_iterations=20_000, absolute_tolerance=0.0,
                                 relative_tolerance=rtol)
            out = {}
            for name, dt in dtypes.items():
                step = make_assembled_step(mesh, dtype=dt, device=dev, options=opts)
                c, res = step(torch.as_tensor(c0, dtype=dt, device=dev))
                out[name] = (c.double(), res)
            gap = float((out["float32"][0] - out["float64"][0]).abs().max())
            emit(part="ch_step1", cells=mesh.num_cells, rtol=rtol, max_abs_gap=gap,
                 **{f"{n}_iterations": r.num_iterations for n, (_, r) in out.items()},
                 **{f"{n}_converged": r.converged for n, (_, r) in out.items()},
                 **{f"{n}_final_residual": float(history(r)[-1]) for n, (_, r) in out.items()})
        if side != 400:
            continue
        opts = SolverOptions(num_iterations=20_000, absolute_tolerance=0.0,
                             relative_tolerance=1e-6)
        for name, dt in dtypes.items():
            step = make_assembled_step(mesh, dtype=dt, device=dev, options=opts)
            c = torch.as_tensor(c0, dtype=dt, device=dev)
            for k in range(3):
                c, res = step(c)
                h = history(res)
                emit(part="ch_march", cells=mesh.num_cells, dtype=name, step=k + 1,
                     r0=float(h[0]), cg_iterations=res.num_iterations, converged=res.converged,
                     first_below_10=first_below(h, 10.0), min_residual=float(np.nanmin(h)))


def part_poisson(torch, dev) -> None:
    """Milestone A to rtol 1e-8 in float32 and float64: where each precision
    crosses 1e-4 and 1e-6, its floor, and the true residual of float32's
    iterate at rtol 1e-4."""
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.precond import JacobiPreconditioner
    from stormx_torch.solvers import SolverOptions, cg, make_operator
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import auto_operator

    mesh = _mesh(400)
    L = assemble_laplacian(mesh)
    Lc = L.to_csr()
    cc = mesh.cell_centers
    rhs = mesh.cell_volumes * np.sin(2 * np.pi * cc[:, 0]) * np.cos(2 * np.pi * cc[:, 1])
    rhs = rhs - rhs.mean()
    diag = L.diagonal().numpy()
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        A = CSR(data=Lc.data.to(dt), indices=Lc.indices, row_ptr=Lc.row_ptr, shape=Lc.shape)
        op, perm = auto_operator(A, coords=cc, device=dev)
        b = torch.as_tensor(rhs[perm], dtype=dt, device=dev)
        jac = JacobiPreconditioner(diag=torch.as_tensor(diag[perm], dtype=dt, device=dev))
        row = {}
        for rtol in (1e-8, 1e-4):
            res = cg(make_operator(op.matvec), b, torch.zeros_like(b), precond=jac,
                     options=SolverOptions(num_iterations=20_000, absolute_tolerance=0.0,
                                           relative_tolerance=rtol))
            x = np.empty(mesh.num_cells)
            x[perm] = res.x.double().cpu().numpy()
            true_res = float(np.linalg.norm(L.matvec(torch.as_tensor(x)).numpy() - rhs)
                             / np.linalg.norm(rhs))
            h = history(res) / float(history(res)[0])
            row[rtol] = dict(cg_iterations=res.num_iterations, converged=res.converged,
                             true_relative_residual=true_res)
            if rtol == 1e-8:
                row.update(first_below_1e4=first_below(h, 1e-4), first_below_1e6=first_below(h, 1e-6),
                           min_relative_residual=float(np.nanmin(h)))
        emit(part="poisson", cells=mesh.num_cells, dtype=name, mode=op.mode,
             rtol_1e8=row.pop(1e-8), rtol_1e4=row.pop(1e-4), **row)


def main() -> int:
    import torch

    part = sys.argv[1] if len(sys.argv) > 1 else ""
    if part == "mesh":
        part_mesh(torch)
        return 0
    if part not in ("ch", "poisson"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_f32_study: this part needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=chip_smoke.nvidia_smi())
    (part_ch if part == "ch" else part_poisson)(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
