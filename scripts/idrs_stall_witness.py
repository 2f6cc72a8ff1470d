#!/usr/bin/env python3
"""Where IDR(s) stops on ``chip_smoke.py`` phase 28's pressure system, on
the CPU, in the JAX package and in the port, serial and sharded (P = 1).

    python3 scripts/idrs_stall_witness.py [--side 400] [--cap 10000] [--rtol 1e-11]
                                          [--only NAME]

One projection step from the Taylor–Green field plus its removable
gradient (``structured_tri_rect(side, side)`` in bandwidth order, dt = 1e-2,
float64, ν = 1e-2) whose IDR(s) (s = 4) pressure solve runs to a relative
residual of ``--rtol`` with a cap of ``--cap`` iterations.  Every run
draws the shadow space with NumPy from the pinned seed in the global
layout, as the distributed solves do, so the four runs differ only in the
pressure operator's product and in how the step builds its right-hand
side:

* ``jax serial``: the JAX package's ``NsProjection`` (ELL product);
* ``jax sharded``: the JAX package's ``ShardedNsProjection`` on one CPU
  device (partitioned CSR product);
* ``port serial``: ``stormx_torch``'s ``NsProjection`` on the CPU;
* ``port sharded``: ``stormx_torch``'s ``ShardedNsProjection`` on one CPU
  thread rank over gloo.

For each it prints the iterations, whether it converged, the smallest
relative residual of its history, the first iteration at or under 1e-8,
1e-9, 1e-10 and 1e-11, the seconds, and max |p − p_ref|, where p_ref is
the same package's serial step with BiCGStab(l) to 1e-11.  This script
imports both packages (as the parity tests do) and runs on the CPU only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT, NU, S, SEED = 1e-2, 1e-2, 4, 20230815


def taylor_green(xy):
    x, y = xy[:, 0], xy[:, 1]
    u = np.sin(np.pi * x) * np.cos(np.pi * y)
    v = -np.cos(np.pi * x) * np.sin(np.pi * y)
    gx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    gy = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return np.stack([u + gx, v + gy], axis=1)


def report(name, n, history, k, converged, seconds, p, p_ref):
    rel = np.asarray(history)[: k + 1] / float(history[0])
    first = {f"{t:g}": (int(np.argmax(rel <= t)) if (rel <= t).any() else None)
             for t in (1e-8, 1e-9, 1e-10, 1e-11)}
    print(f"{name}: cells {n}, iterations {k}, converged {bool(converged)}, smallest relative "
          f"residual {float(np.nanmin(rel[1:])):.3e}, first under {first}, {seconds:.1f} s, "
          f"max |p - p_ref| {float(np.abs(np.asarray(p) - p_ref).max()):.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=400)
    ap.add_argument("--cap", type=int, default=10_000)
    ap.add_argument("--rtol", type=float, default=1e-11)
    ap.add_argument("--only", choices=("jax serial", "jax sharded", "port serial",
                                       "port sharded"), action="append")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from stormx.apps.navier_stokes import NsProjection as JNs
    from stormx.mesh import structured_tri_rect as j_rect
    from stormx.parallel.ns import ShardedNsProjection as JSharded
    from stormx.solvers import SolverOptions as JOptions
    from stormx_torch.apps.navier_stokes import NsProjection as TNs
    from stormx_torch.mesh import structured_tri_rect as t_rect
    from stormx_torch.parallel.comm import run_thread_ranks
    from stormx_torch.parallel.ns import ShardedNsProjection as TSharded
    from stormx_torch.solvers import SolverOptions as TOptions

    jm = j_rect(args.side, args.side).optimize_for_tpu()
    tm = t_rect(args.side, args.side).optimize_ordering()
    assert np.array_equal(np.asarray(jm.cell_nodes), np.asarray(tm.cell_nodes))
    n = tm.num_cells
    vel = taylor_green(np.asarray(tm.cell_centers))
    shadow = np.random.default_rng(SEED).standard_normal((S - 1, n))
    tol = dict(num_iterations=args.cap, absolute_tolerance=0.0, relative_tolerance=args.rtol)
    ref = dict(num_iterations=args.cap, absolute_tolerance=0.0, relative_tolerance=1e-11)
    wanted = set(args.only or ("jax serial", "jax sharded", "port serial", "port sharded"))
    j_ref = t_ref = None
    if wanted & {"jax serial", "jax sharded"}:
        j_ref = np.asarray(JNs(jm, nu=NU, method="bicgstab_l", solver_kw={
            "options": JOptions(**ref)}).step(jnp.asarray(vel), DT)[1])
    if wanted & {"port serial", "port sharded"}:
        t_ref = TNs(tm, nu=NU, method="bicgstab_l", dtype=torch.float64, device="cpu",
                    solver_kw={"options": TOptions(**ref)}).step(torch.as_tensor(vel),
                                                                 DT)[1].numpy()

    if "jax serial" in wanted:
        ns = JNs(jm, nu=NU, method="idrs",
                 solver_kw={"options": JOptions(**tol), "shadow": jnp.asarray(shadow)})
        t0 = time.perf_counter()
        _, p, res = ns.step(jnp.asarray(vel), DT)[:3]
        res.x.block_until_ready()
        report("jax serial", n, res.history, int(res.num_iterations), res.converged,
               time.perf_counter() - t0, p, j_ref)
    if "jax sharded" in wanted:
        ns = JSharded(jm, nu=NU, num_parts=1, method="idrs",
                      solver_kw={"options": JOptions(**tol), "shadow_seed": SEED})
        t0 = time.perf_counter()
        _, p, res = ns.step(jnp.asarray(vel), DT)[:3]
        res.x.block_until_ready()
        report("jax sharded", n, res.history, int(res.num_iterations), res.converged,
               time.perf_counter() - t0, p, j_ref)
    if "port serial" in wanted:
        ns = TNs(tm, nu=NU, method="idrs", dtype=torch.float64, device="cpu",
                 solver_kw={"options": TOptions(**tol), "shadow": torch.as_tensor(shadow)})
        t0 = time.perf_counter()
        _, p, res = ns.step(torch.as_tensor(vel), DT)[:3]
        report("port serial", n, res.history.numpy(), res.num_iterations, res.converged,
               time.perf_counter() - t0, p.numpy(), t_ref)
    if "port sharded" in wanted:
        def rank(mesh):
            ns = TSharded(tm, nu=NU, num_parts=1, method="idrs", device_mesh=mesh,
                          dtype=torch.float64, solver_kw={"options": TOptions(**tol),
                                                          "shadow_seed": SEED})
            return ns.step(torch.as_tensor(vel), DT)

        t0 = time.perf_counter()
        _, p, res = run_thread_ranks(1, rank, device="cpu", timeout=3600.0)[0]
        report("port sharded", n, res.history.numpy(), res.num_iterations, res.converged,
               time.perf_counter() - t0, p.numpy(), t_ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
