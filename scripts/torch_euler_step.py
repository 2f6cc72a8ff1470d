#!/usr/bin/env python3
"""The Euler order-2 step of ``chip_smoke.py``'s ``euler`` phase, timed, and
the host's time a K3 call, on one CUDA card.

    python3 scripts/torch_euler_step.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``stormx_torch`` is imported (this one
by default), so two commits can be compared in one run on one card: unpack
the other with ``git archive`` into a directory ``.gitignore`` lists and run
this script once with each root, in turns.

On the 318,402-cell jittered Delaunay mesh of ``chip_smoke.py``, float32
with K3's plans, it marches the Sod state with slip walls at CFL 0.2:
``STEPS`` order-2 steps, ``REPEATS`` times, each timed on the host from a
synchronise to a synchronise (the step's wall time, launches included),
and prints the median ms a step, K3's launches a step by branch (where the
tree counts them) and a SHA-256 of the final state's bytes, so two trees'
states can be compared bit for bit.  It then marches the same state
through ``sharded_fv_march`` at P = 1 under NCCL and hashes that too.
Last, the host's µs a K3 call: ``CALLS`` calls of the face_inner plan on
a float32 field of nv = 5 (the "vector" branch) and of nv = 1 ("vec4")
back to back with no synchronisation (the card queues them faster than it
runs them), median and least of ``HOST_REPEATS`` runs.  One JSON line,
then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 200
SHARDED_STEPS = 20
REPEATS = 5
HOST_REPEATS = 15
CALLS = 400


def smoke_module():
    """This checkout's chip_smoke.py (mesh and state builders only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                            "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="the checkout to import stormx_torch from")
    parser.add_argument("--label", default="", help="a name printed with the line")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_euler_step: no CUDA device is available", file=sys.stderr)
        return 2
    import stormx_torch
    from stormx_torch.fvm import FvSolver, slip_bc
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops import _cuda, banded_gather
    from stormx_torch.parallel import partition_fv, sharded_fv_march

    cs = smoke_module()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _cuda.build(["banded_gather"])
    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    dm = mesh.device_arrays(torch.float32, device=dev, banded_gather=True)
    u0 = cs.riemann_state(torch, mesh.cell_centers, torch.float32, dev)
    dt = cs.cfl_dt(mesh, float(np.sqrt(1.4)))
    solver = FvSolver(dm, bcs={1: slip_bc})
    solver.march(u0, dt, 5)
    torch.cuda.synchronize()
    by_branch = getattr(banded_gather, "branch_launches", None)
    before = dict(by_branch) if by_branch is not None else None
    k3_before = banded_gather.launches
    ms = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = solver.march(u0, dt, STEPS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / STEPS)
    per_step = (banded_gather.launches - k3_before) / (REPEATS * STEPS)
    branches = (None if by_branch is None else
                {b: (by_branch[b] - before[b]) / (REPEATS * STEPS) for b in by_branch})

    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    from stormx_torch.parallel import make_device_mesh

    rank = make_device_mesh(1, device=dev)
    pfv = partition_fv(mesh.device_arrays(torch.float64, device="cpu", banded_gather=False), 1)
    u_sharded = sharded_fv_march(pfv, u0.cpu().numpy(), dt, SHARDED_STEPS, bcs={1: slip_bc},
                                 mesh=rank, order=2)
    u_serial = solver.march(u0, dt, SHARDED_STEPS)
    dist.destroy_process_group()

    plan = dm.bg_face_inner
    host_us = {}
    for nv in (5, 1):
        x = torch.randn((plan.n_src, nv) if nv > 1 else (plan.n_src,),
                        generator=torch.Generator().manual_seed(0)).to(dev)
        runs = []
        for _ in range(HOST_REPEATS):
            plan(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                plan(x)
            runs.append((time.perf_counter() - t0) * 1e6 / CALLS)
            torch.cuda.synchronize()
        host_us[f"nv{nv}"] = dict(median=statistics.median(runs), least=min(runs))
    print(json.dumps(dict(label=args.label, root=os.path.abspath(args.root),
                          package=os.path.dirname(stormx_torch.__file__), cells=mesh.num_cells,
                          steps=STEPS, repeats=REPEATS, ms_per_step=statistics.median(ms),
                          ms_per_step_runs=ms, k3_launches_per_step=per_step,
                          k3_launches_per_step_by_branch=branches,
                          state_sha256=digest(u), sharded_steps=SHARDED_STEPS,
                          sharded_p1_sha256=digest(u_sharded),
                          serial_sha256_same_steps=digest(u_serial),
                          k3_host_us_per_call=host_us)), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
