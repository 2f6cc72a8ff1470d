#!/usr/bin/env python3
"""Where float32 preconditioned solves part from float64 ones on the card.

    python3 scripts/torch_precond_study.py [SIDE]

Runs on a CUDA card, from the root of a checkout (``SIDE`` = 400 by default:
``chip_smoke.py``'s 318,402-cell jittered Delaunay mesh).  It prints one
line per solve:

* ``laplacian``: CG + ``AmgPreconditioner`` on Milestone A's pure-Neumann
  Laplacian and volume-weighted right-hand side (rtol 1e-4), in float64
  through the plain ELL product, and in float32 with the fine level
  through K1 and through the ELL product; CG + ``ChebyshevPreconditioner``
  (degree 4) with λmax from 10 power iterations and from Gershgorin's bound,
  in both precisions.  Before the solves, the relative error of K1's
  float32 product against float64 on a random and on a smooth vector, and
  of one float32 V-cycle against the float64 one.
* ``diffusion``: the implicit diffusion step V + τ·L at τ = 1e-3, 1e-2 and
  0.1 (rtol 1e-5, a random right-hand side): CG + Jacobi, AMG and Chebyshev
  in float32 through K1 and in float64.
* ``convdiff``: FGMRES + ILU(0) (3 sweeps) on the convection–diffusion
  operator of ``chip_smoke.py`` phase 17, orthogonalized by MGS and by CGS2,
  in both precisions.

Each line gives converged, iterations, the true relative residual in
float64, and seconds.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_precond_study: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops import _cuda
    from stormx_torch.precond import (AmgPreconditioner, ChebyshevPreconditioner,
                                      IluPreconditioner, JacobiPreconditioner)
    from stormx_torch.solvers import SolverOptions, cg, fgmres, make_operator
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import _permuted_csr, auto_operator, sell_from_csr

    side = int(sys.argv[1]) if len(sys.argv) > 1 else cs.GRID_SIDE
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build(["sell_spmv"])
    print(cs.nvidia_smi(), flush=True)
    f32, f64 = torch.float32, torch.float64
    pts, tris = cs.delaunay_mesh(side, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    n, c = mesh.num_cells, mesh.cell_centers
    lap = assemble_laplacian(mesh).to_csr()
    lop, perm = auto_operator(CSR(data=lap.data.float(), indices=lap.indices,
                                  row_ptr=lap.row_ptr, shape=lap.shape), coords=c, device=dev)
    l_csr, _ = _permuted_csr(lap, perm)
    l64 = cs.device_ell(torch, l_csr, f64, dev)
    l32 = cs.device_ell(torch, l_csr, f32, dev)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def run(label, solver, op, b, b64, op64, pre, rtol, **kw):
        t0 = time.perf_counter()
        res = solver(make_operator(op), b, torch.zeros_like(b), precond=pre,
                     options=SolverOptions(num_iterations=10_000, absolute_tolerance=0.0,
                                           relative_tolerance=rtol, record_history=False),
                     **kw)
        torch.cuda.synchronize()
        true = float((b64 - op64.matvec(res.x.double())).norm() / b64.norm())
        print(f"{label}: converged={res.converged} iterations={res.num_iterations} "
              f"true_residual={true:.3e} seconds={time.perf_counter() - t0:.2f}", flush=True)

    # -- Milestone A's Laplacian --------------------------------------------------
    rhs = mesh.cell_volumes * np.sin(2 * np.pi * c[:, 0]) * np.cos(2 * np.pi * c[:, 1])
    rhs = rhs - rhs.mean()
    b64 = torch.as_tensor(rhs[perm], device=dev)
    b32 = b64.float()
    for name, x in (("random", torch.randn(n, device=dev)),
                    ("smooth", torch.as_tensor(np.cos(3 * c[perm, 0]), dtype=f32, device=dev))):
        gap = rel(lop.matvec(x), l64.matvec(x.double()))
        print(f"laplacian product, {name} x: K1 against float64 {gap:.3e}", flush=True)
    amg_k1 = AmgPreconditioner(l_csr, fine_matvec=lop.matvec, dtype=f32, device=dev)
    amg_ell = AmgPreconditioner(l_csr, dtype=f32, device=dev)
    amg64 = AmgPreconditioner(l_csr, dtype=f64, device=dev)
    print(f"laplacian AMG levels {[lvl['n'] for lvl in amg64._levels]} coarse "
          f"{amg64._coarse_inv.shape[0]}; one float32 V-cycle against float64: "
          f"{rel(amg_k1(b32), amg64(b64)):.3e}", flush=True)
    run("laplacian cg+amg float64", cg, l64.matvec, b64, b64, l64, amg64, 1e-4)
    run("laplacian cg+amg float32 K1", cg, lop.matvec, b32, b64, l64, amg_k1, 1e-4)
    run("laplacian cg+amg float32 ELL", cg, l32.matvec, b32, b64, l64, amg_ell, 1e-4)
    rows = np.repeat(np.arange(n), np.diff(l_csr.row_ptr))
    gershgorin = float(np.bincount(rows, np.abs(l_csr.data)).max())
    for lmax in (None, gershgorin):
        c32 = ChebyshevPreconditioner(4, lambda_max=lmax).build(None, b32, lop.matvec)
        c64 = ChebyshevPreconditioner(4, lambda_max=lmax).build(None, b64, l64.matvec)
        label = "power iteration" if lmax is None else "Gershgorin"
        print(f"laplacian chebyshev λmax ({label}): {float(c32._lmax):.6g} float32, "
              f"{float(c64._lmax):.6g} float64", flush=True)
        run(f"laplacian cg+chebyshev({label}) float32 K1", cg, lop.matvec, b32, b64, l64, c32,
            1e-4)
        run(f"laplacian cg+chebyshev({label}) float64", cg, l64.matvec, b64, b64, l64, c64, 1e-4)

    # -- the implicit diffusion step V + τ·L ---------------------------------------
    rng = np.random.default_rng(2)
    diag = np.where(l_csr.indices == rows, mesh.cell_volumes[perm][rows], 0.0)
    for tau in (1e-3, 1e-2, 0.1):
        h_csr = CSR(data=tau * l_csr.data + diag, indices=l_csr.indices,
                    row_ptr=l_csr.row_ptr, shape=l_csr.shape)
        h_op, _ = sell_from_csr(CSR(data=h_csr.data.astype(np.float32), indices=h_csr.indices,
                                    row_ptr=h_csr.row_ptr, shape=h_csr.shape),
                                mode="cuda", reorder=False, device=dev)
        h64 = cs.device_ell(torch, h_csr, f64, dev)
        b64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        b32 = b64.float()
        d = torch.as_tensor(h_csr.data[h_csr.indices == rows], device=dev)
        for label, op, b, pre in (
                ("jacobi float32 K1", h_op.matvec, b32, JacobiPreconditioner(diag=d.float())),
                ("jacobi float64", h64.matvec, b64, JacobiPreconditioner(diag=d)),
                ("amg float32 K1", h_op.matvec, b32,
                 AmgPreconditioner(h_csr, fine_matvec=h_op.matvec, dtype=f32, device=dev)),
                ("amg float64", h64.matvec, b64, AmgPreconditioner(h_csr, dtype=f64, device=dev)),
                ("chebyshev float32 K1", h_op.matvec, b32, ChebyshevPreconditioner(4)),
                ("chebyshev float64", h64.matvec, b64, ChebyshevPreconditioner(4))):
            run(f"diffusion τ={tau:g} cg+{label}", cg, op, b, b64, h64, pre, 1e-5)

    # -- convection-diffusion ---------------------------------------------------------
    ell = assemble_convection_diffusion(mesh, cs.rotating_velocity, cs.CONVDIFF_EPS)
    cd = ell.to_csr()
    cd_op, cd_perm = auto_operator(CSR(data=cd.data.float(), indices=cd.indices,
                                       row_ptr=cd.row_ptr, shape=cd.shape), coords=c, device=dev)
    p_cd, _ = _permuted_csr(cd, cd_perm)
    cd64 = cs.device_ell(torch, p_cd, f64, dev)
    b64 = torch.as_tensor((np.sin(2 * np.pi * c[:, 0]) * np.cos(np.pi * c[:, 1]) + 0.1)[cd_perm],
                          device=dev)
    ilu = IluPreconditioner(p_cd, sweeps=3, dtype=f32, device=dev)
    ilu64 = cs.as_float64(torch, ilu)
    for orthog in ("mgs", "cgs2"):
        run(f"convdiff fgmres+ilu0 {orthog} float32 K1", fgmres, cd_op.matvec, b64.float(), b64,
            cd64, ilu, 1e-5, orthog=orthog)
        run(f"convdiff fgmres+ilu0 {orthog} float64", fgmres, cd64.matvec, b64, b64, cd64, ilu64,
            1e-5, orthog=orthog)
    return 0


if __name__ == "__main__":
    sys.exit(main())
