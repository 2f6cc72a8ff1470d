#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 22-23 (``run_complex``, ``run_io``) alone.

    python3 scripts/torch_io_complex_phases.py

On a CUDA card, from the root of a checkout.  It builds the kernels and the
smoke's 318,402-cell mesh as phases 1-2 do (without running the other
phases) and the projection's 320,000-cell ``structured_tri_rect``, then the
two phases, and prints the seconds each took beside their JSON lines.
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
        print("torch_io_complex_phases: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.mesh import read_tetgen, structured_tri_rect
    from stormx_torch.ops import _cuda

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
    ctx = dict(mesh=mesh,
               ns_mesh=structured_tri_rect(cs.NS_SIDE, cs.NS_SIDE).optimize_ordering())
    print("setup_s", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    entries = cs.run_complex(torch, dev, ctx)
    print("complex_s", time.perf_counter() - t0,
          {e["name"]: e["launches"] for e in entries}, flush=True)
    t0 = time.perf_counter()
    launches = cs.run_io(torch, dev, ctx)
    print("io_s", time.perf_counter() - t0, launches, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
