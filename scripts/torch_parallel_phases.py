#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 24-25 (``run_parallel``,
``run_parallel_banded``) alone.

    python3 scripts/torch_parallel_phases.py

On a CUDA card, from the root of a checkout.  It builds the kernels and the
smoke's 318,402-cell mesh as phases 1-2 do, runs phase 8's serial banded CG
(the yardstick of phase 25) without the other phases, then the two phases,
and prints the seconds each took beside their JSON lines.
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
        print("torch_parallel_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops import _cuda
    from stormx_torch.parallel.comm import RankPool

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("build_s", _cuda.build(), cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    ctx = dict(mesh=mesh, laplacian=assemble_laplacian(mesh))
    print("setup_s", time.perf_counter() - t0, flush=True)
    pool = RankPool(cs.PAR_PARTS, device=dev, timeout=cs.PAR_TIMEOUT)
    try:
        t0 = time.perf_counter()
        entry = cs.run_parallel(torch, dev, ctx, pool)
        print("parallel_s", time.perf_counter() - t0,
              {k: entry[k] for k in ("launches", "ms", "plain_ms", "library_ms", "bound_ms")},
              flush=True)
        run_banded_phase(torch, dev, cs, pool)
    finally:
        pool.close()
    return 0


def run_banded_phase(torch, dev, cs, pool) -> None:
    """Phase 8's serial banded CG (the yardstick), then phase 25."""
    from stormx_torch.solvers import SolverOptions, solve
    from stormx_torch.sparse.formats import DIA

    offsets, data = cs.poisson5_diags(cs.NX)
    n = cs.NX * cs.NX
    op = DIA(data=torch.as_tensor(data, device=dev), offsets=offsets, shape=(n, n))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n).astype(np.float32),
                        device=dev)
    t0 = time.perf_counter()
    res = solve(op, b, method="cg", options=SolverOptions(
        num_iterations=cs.CG_MAX_ITERATIONS, absolute_tolerance=0.0,
        relative_tolerance=cs.BANDED_RTOL))
    torch.cuda.synchronize()
    serial = dict(iterations=res.num_iterations,
                  ms_per_iteration=1e3 * (time.perf_counter() - t0) / max(res.num_iterations, 1),
                  true_relative_residual=cs.true_residual(torch, op, res.x, b))
    del op, b, res
    t0 = time.perf_counter()
    cs.run_parallel_banded(torch, dev, cs.NX, serial, pool)
    print("parallel_banded_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    sys.exit(main())
