#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 20-21 (``run_precond``, ``run_lsq``) alone.

    python3 scripts/torch_precond_phases.py

On a CUDA card, from the root of a checkout.  It builds the kernels, the
smoke's 318,402-cell mesh, the CH operator, Milestone A's Laplacian and the
convection-diffusion operator as phases 2-5 and 17 do (without running
those phases), then the two phases, and prints the seconds each took beside
their JSON lines (about two minutes in all).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_precond_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops import _cuda
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import auto_operator

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("build_s", _cuda.build(), cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    step = make_assembled_step(mesh, dtype=torch.float32, device=dev)
    lap = assemble_laplacian(mesh)
    lc = lap.to_csr()
    c = mesh.cell_centers
    _, perm = auto_operator(CSR(data=lc.data.float(), indices=lc.indices, row_ptr=lc.row_ptr,
                                shape=lc.shape), coords=c, device=dev)
    cd = assemble_convection_diffusion(mesh, cs.rotating_velocity, cs.CONVDIFF_EPS).to_csr()
    cd_op, cd_perm = auto_operator(CSR(data=cd.data.float(), indices=cd.indices,
                                       row_ptr=cd.row_ptr, shape=cd.shape), coords=c, device=dev)
    ctx = dict(mesh=mesh, ch_op=step.operator, laplacian=lap, perm=perm,
               convdiff=dict(csr=cd, op=cd_op, perm=cd_perm))
    print("setup_s", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    entries = cs.run_precond(torch, dev, ctx)
    print("precond_s", time.perf_counter() - t0,
          {e["name"]: e["launches"] for e in entries}, flush=True)
    t0 = time.perf_counter()
    lsq_tri, _ = cs.run_lsq(torch, dev, ctx)
    print("lsq_s", time.perf_counter() - t0, lsq_tri, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
