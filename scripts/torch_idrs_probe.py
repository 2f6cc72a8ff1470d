#!/usr/bin/env python3
"""Where serial IDR(s) stops on ``chip_smoke.py`` phase 28's pressure system.

    python3 scripts/torch_idrs_probe.py [--device cpu] [--side 400] [--rtol 1e-11]

One projection step's pressure solve (``NsProjection`` on the
``structured_tri_rect(side, side)`` mesh, ``optimize_ordering``, the
Taylor–Green field plus its removable gradient, dt = 1e-2, float64) with
BiCGStab(l) to 1e-11, then with IDR(s) (s = 4) to ``--rtol``, once with its
own shadow space (``torch.Generator``) and once with the NumPy draw the
distributed solves use; a cap of 10,000 iterations each.  For each it
prints the iterations, whether it converged, the smallest relative residual
of its history, the first iteration at or under 1e-8, 1e-9, 1e-10 and
1e-11, the seconds, and max |p − p_ref| against the BiCGStab(l) step; on a
card, with its name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=400)
    ap.add_argument("--rtol", type=float, default=1e-11)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.apps.navier_stokes import NsProjection
    from stormx_torch.mesh import structured_tri_rect
    from stormx_torch.solvers import SolverOptions
    from stormx_torch.solvers.idrs import _SHADOW_SEED

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_idrs_probe: no CUDA device is available", file=sys.stderr)
            return 2
        print(cs.nvidia_smi(), flush=True)
    mesh = structured_tri_rect(args.side, args.side).optimize_ordering()
    vel = torch.as_tensor(cs.taylor_green(mesh.cell_centers), device=dev)
    shadow = torch.as_tensor(np.random.default_rng(_SHADOW_SEED).standard_normal(
        (3, mesh.num_cells)), device=dev)
    p_ref = None
    for name, method, kw, rtol in (("bicgstab_l", "bicgstab_l", {}, 1e-11),
                                   ("idrs, own shadow", "idrs", {}, args.rtol),
                                   ("idrs, NumPy shadow", "idrs", {"shadow": shadow}, args.rtol)):
        opts = SolverOptions(num_iterations=10_000, absolute_tolerance=0.0,
                             relative_tolerance=rtol)
        ns = NsProjection(mesh, method=method, solver_kw={"options": opts, **kw},
                          dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        _, p, res, _ = ns.step(vel, cs.NS_DT)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        p_ref = p if p_ref is None else p_ref
        k = res.num_iterations
        rel = res.history[: k + 1].cpu().numpy() / float(res.history[0])
        first = {f"{t:g}": (int(np.argmax(rel <= t)) if (rel <= t).any() else None)
                 for t in (1e-8, 1e-9, 1e-10, 1e-11)}
        print(f"{name} to {rtol:g}: cells {mesh.num_cells}, iterations {k}, converged "
              f"{res.converged}, smallest relative residual {float(np.nanmin(rel[1:])):.3e}, "
              f"first under {first}, {seconds:.1f} s, max |p - p_ref| "
              f"{float((p - p_ref).abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
