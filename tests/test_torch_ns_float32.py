"""Where the float32 projection's corrected face-flux divergence comes
from: the port's ``NsProjection`` step and the JAX package's, both in
float32 on the CPU with CG to a relative 1e-4, on the Taylor–Green field of
``tests/test_navier_stokes.py`` on ``structured_tri_rect(side, side)``.

The ratio read is ‖div F − mean‖₂/‖div v₀‖₂ of the corrected face fluxes F,
summed in float64.  In float64 (CG to 1e-8) it is ~1e-8.  Rounding the
float64 step's face fluxes to float32 moves it to ~1e-5 of that scale, and
rounding its pressure to float32 to ~1e-3; the float32 step in either
package reaches far more, because float32 CG stops on its recurrence
residual (1e-4) while its true residual ‖A·p − b‖/‖b‖ is orders larger.
The corrected divergence equals dt times that true residual (the
correction is the Poisson operator's own stencil), so the float32 gate of
``chip_smoke.py``'s ``ns_projection`` phase is set from this floor, and its
tight gate holds the card's corrected fluxes to their own pressure.

As a script it prints these readings at a side (the smoke's is 400, ~2 min
and ~3 GB here)::

    JAX_PLATFORMS=cpu python3 tests/test_torch_ns_float32.py SIDE
"""

from __future__ import annotations

import json
import os
import sys

if __name__ == "__main__":  # pragma: no cover - script mode
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from stormx.apps.navier_stokes import NsProjection as JNs
from stormx.mesh import structured_tri_rect as j_tri_rect
from stormx.solvers import SolverOptions as JOptions
from stormx_torch.apps.navier_stokes import (NsProjection, cell_divergence, face_fluxes,
                                             flux_divergence)
from stormx_torch.mesh import build_mesh
from stormx_torch.solvers import SolverOptions

DT = 1e-2
RTOL32 = 1e-4


def _taylor_green(xy):
    x, y = xy[:, 0], xy[:, 1]
    u = np.sin(np.pi * x) * np.cos(np.pi * y)
    v = -np.cos(np.pi * x) * np.sin(np.pi * y)
    gx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)
    gy = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)
    return np.stack([u + gx, v + gy], axis=1)


def _jax_float32(jns):
    """The JAX projection with its mesh arrays, LSQ matrices and Poisson
    operator cast to float32 (the package builds them in float64 here)."""
    def f32(a):
        return (a.astype(jnp.float32)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a)

    dm = jns.dmesh
    jns.dmesh = dataclasses.replace(dm, **{f.name: f32(getattr(dm, f.name))
                                           for f in dataclasses.fields(dm)})
    jns._poisson = dataclasses.replace(jns._poisson, data=jns._poisson.data.astype(jnp.float32))
    jns._g_mats = f32(jns._g_mats)
    return jns


def readings(side: int) -> dict:
    jm = j_tri_rect(side, side)
    mesh = build_mesh(jm.node_positions, jm.cell_nodes)
    vel0 = _taylor_green(jm.cell_centers)

    def port(dtype, rtol):
        opts = SolverOptions(num_iterations=20_000, absolute_tolerance=0.0,
                             relative_tolerance=rtol, record_history=False)
        return NsProjection(mesh, nu=1e-2, method="cg", solver_kw={"options": opts},
                            banded_gather=False, dtype=dtype, device="cpu")

    ns64 = port(torch.float64, 1e-8)
    dm = ns64.dmesh
    d0 = torch.linalg.vector_norm(cell_divergence(dm, torch.as_tensor(vel0)))

    def ratio(flux):
        df = flux_divergence(dm, torch.as_tensor(np.asarray(flux, dtype=np.float64)))
        return float(torch.linalg.vector_norm(df - df.mean()) / d0)

    def true_residual(v_star, p):
        """‖A·p − b‖/‖b‖ in float64, and the divergence ratio it implies,
        dt·‖r − mean‖/‖div v₀‖."""
        div = flux_divergence(dm, face_fluxes(dm, v_star.double())) / DT
        b = div - div.mean()
        r = b - ns64._poisson.matvec(p.double())
        return (float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)),
                float(DT * torch.linalg.vector_norm(r - r.mean()) / d0))

    v_star = ns64.predictor(torch.as_tensor(vel0), DT)
    flux = face_fluxes(dm, v_star)
    p64, res64 = ns64.pressure_solve(flux_divergence(dm, flux) / DT)
    out = dict(side=side, cells=mesh.num_cells,
               float64=ratio(ns64.correct_fluxes(flux, p64, DT)),
               float64_flux_rounded=ratio(ns64.correct_fluxes(flux.float().double(), p64, DT)),
               float64_p_rounded=ratio(ns64.correct_fluxes(flux, p64.float().double(), DT)))
    ns32 = port(torch.float32, RTOL32)
    vel = torch.as_tensor(vel0, dtype=torch.float32)
    _, p32, res32, flux32 = ns32.step(vel, DT)
    true, implied = true_residual(ns32.predictor(vel, DT), p32)
    out["port_float32"] = dict(ratio=ratio(flux32.numpy()), cg_iterations=res32.num_iterations,
                               reported_residual=float(res32.relative_error),
                               true_residual=true, ratio_from_true_residual=implied)
    jns = _jax_float32(JNs(jm, nu=1e-2, method="cg", solver_kw={"options": JOptions(
        num_iterations=20_000, absolute_tolerance=0.0, relative_tolerance=RTOL32)}))
    jv_star = jns.predictor(jnp.asarray(vel0, jnp.float32), DT)
    _, jp32, jres32, jflux32 = jns.step(jnp.asarray(vel0, jnp.float32), DT)
    true, implied = true_residual(torch.as_tensor(np.array(jv_star)),
                                  torch.as_tensor(np.array(jp32)))
    out["jax_float32"] = dict(ratio=ratio(jflux32), cg_iterations=int(jres32.num_iterations),
                              reported_residual=float(jres32.relative_error),
                              true_residual=true, ratio_from_true_residual=implied)
    return out


def test_float32_projection_floor_is_cg_true_residual():
    """At side 100: both packages' float32 CG stop on a reported 1e-4 with a
    true residual over 10× larger; their corrected divergence ratios agree
    to a factor 2 and lie over 10× above the float32 rounding of the
    float64 step's pressure, and that in turn far above the rounding of its
    face fluxes.  The port's ratio is the one its pressure's true residual
    implies, to 1e-2 (the smoke's ``NS_IDENTITY``)."""
    r = readings(100)
    assert r["float64"] < 1e-7
    assert r["float64_flux_rounded"] < 0.1 * r["float64_p_rounded"]
    for pkg in ("port_float32", "jax_float32"):
        assert r[pkg]["reported_residual"] <= RTOL32
        assert r[pkg]["true_residual"] > 10 * RTOL32, r
        assert r[pkg]["ratio"] > 10 * r["float64_p_rounded"], r
    assert 0.5 < r["port_float32"]["ratio"] / r["jax_float32"]["ratio"] < 2.0, r
    port = r["port_float32"]
    assert abs(port["ratio"] - port["ratio_from_true_residual"]) <= 1e-2 * port["ratio"], r


if __name__ == "__main__":  # pragma: no cover - script mode
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    print(json.dumps(readings(int(sys.argv[1]) if len(sys.argv) > 1 else 100)))
