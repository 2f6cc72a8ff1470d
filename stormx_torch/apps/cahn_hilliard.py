"""Cahn–Hilliard implicit time stepping (counterpart of
``stormx/apps/cahn_hilliard.py``).

Reference: ``source_apps/playground/Playground.cpp:111-210`` — each step an
implicit CG solve with f = dF/dc = 2c(c−1)(2c−1) (:142-144), τ = 1e-3,
Γ = 1e-4, σ = 2 (:113).  The port runs eagerly on the device; a step is a
Python-driven CG loop whose SpMV is kernel K1 (assembled path) or whose
div-grad gathers are kernel K3 (matrix-free path).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stormx_torch.core.config import default_real_dtype, resolve_device
from stormx_torch.fvm.divgrad import div_grad
from stormx_torch.solvers import SolverOptions, cg, make_operator

__all__ = ["dF_dc", "make_step", "make_assembled_step", "run", "main",
           "TAU", "GAMMA_CH", "SIGMA"]

TAU = 1.0e-3  # Playground.cpp:113
GAMMA_CH = 1.0e-4
SIGMA = 2.0


def dF_dc(c):
    """Double-well potential derivative (Playground.cpp:142-144)."""
    return 2.0 * c * (c - 1.0) * (2.0 * c - 1.0)


def _check_on(dmesh, device) -> None:
    dev = resolve_device(device)
    if dmesh.device.type != dev.type:
        raise ValueError(f"the device mesh lies on {dmesh.device}, not on {dev}")


def make_step(dmesh, *, tau=TAU, gamma=GAMMA_CH, sigma=SIGMA, options=None,
              device="cuda"):
    """The matrix-free step c → (c_hat, solve_stats) on ``dmesh``, which must
    lie on ``device``."""
    _check_on(dmesh, device)
    opts = options or SolverOptions()

    def step(c):
        f = dF_dc(c)

        def op(c_in):
            # w_hat = f + σ(c_in − c) − Γ·divgrad(c_in) (:157-159)
            w_hat = f + sigma * (c_in - c)
            w_hat = div_grad(dmesh, w_hat, -gamma, c_in)
            # c_hat = c_in − τ·divgrad(w_hat) (:163-166)
            return div_grad(dmesh, c_in, -tau, w_hat)

        # The operator is affine, so uniformize before CG (the reference's
        # solve_non_uniform, Solver.hpp:271-292): [𝓐(x) − 𝓐(0)] = c − 𝓐(0).
        z = op(torch.zeros_like(c))
        res = cg(make_operator(lambda x: op(x) - z), c - z, c, options=opts)
        return res.x, res

    return step


def make_assembled_step(mesh, *, tau=TAU, gamma=GAMMA_CH, sigma=SIGMA,
                        options=None, dtype=None, device="cuda"):
    """Assembled-operator step: ``A = I − τσ·D + τγ·D²`` (D the
    volume-weighted div-grad) is assembled ONCE per mesh on the host and
    served through ``auto_operator`` — kernel K1 for float32 on CUDA.  The
    affine constant is one matrix-free ``div_grad`` per step.

    The step function carries the operator as ``step.operator`` and the
    device mesh as ``step.dmesh``.
    """
    from stormx_torch.fvm.divgrad import assemble_divgrad
    from stormx_torch.sparse.formats import CSR, ell_add, ell_spgemm
    from stormx_torch.sparse.windowed import auto_operator

    dev = resolve_device(device)
    dtype = dtype or default_real_dtype()
    opts = options or SolverOptions()
    D = assemble_divgrad(mesh)
    D2 = ell_spgemm(D, D)
    A = ell_add(
        [(1.0, None), (-tau * sigma, D), (tau * gamma, D2)],
        (mesh.num_cells, mesh.num_cells),
    )
    A = CSR(data=A.data.to(dtype), indices=A.indices, row_ptr=A.row_ptr, shape=A.shape)
    op, perm = auto_operator(A, coords=np.asarray(mesh.cell_centers), device=dev)
    inv = np.argsort(perm)
    perm_t = torch.as_tensor(perm, device=dev)
    inv_t = torch.as_tensor(inv, device=dev)
    dmesh = mesh.device_arrays(dtype=dtype, device=dev)

    def step(c):
        f = dF_dc(c)
        # Affine constant 𝓐(0) = −τ·D(f − σc), matrix-free.
        z = div_grad(dmesh, torch.zeros_like(c), -tau, f - sigma * c)
        rhs = (c - z)[perm_t]
        res = cg(make_operator(op.matvec), rhs, c[perm_t], options=opts)
        return res.x[inv_t], res

    step.operator = op
    step.dmesh = dmesh
    return step


def run(dmesh, c0, num_steps: int, *, mesh=None, output_every: int | None = None,
        output_dir: str = ".", checkpointer=None, start_step: int = 0,
        assembled: bool = False, device="cuda", **kw):
    """Time loop (Playground.cpp:187-209); returns the final concentration.

    Mirrors the Playground driver's side channels: ``output_every`` writes
    ``out_cahn_hilliard_<k>.vtk`` snapshots into ``output_dir`` (≙
    ``save_vtk``, :66-109,207-208 — needs ``mesh``), and a
    :class:`stormx_torch.io.Checkpointer` saves ``{"c": c, "step": k}``
    after step k, so the run is restartable (``start_step`` resumes the
    count).  ``assembled=True`` (needs ``mesh``) solves through the
    once-assembled operator.
    """
    if assembled:
        if mesh is None:
            raise ValueError("assembled=True needs the host mesh")
        step = make_assembled_step(mesh, device=device, **kw)
    else:
        step = make_step(dmesh, device=device, **kw)
    c = c0
    for k in range(start_step, start_step + num_steps):
        c, _ = step(c)
        if output_every and mesh is not None and (k + 1) % output_every == 0:
            from stormx_torch.io import write_vtk

            write_vtk(mesh, os.path.join(output_dir, f"out_cahn_hilliard_{k + 1}.vtk"),
                      {"c": c})
        if checkpointer is not None:
            checkpointer.maybe_save(k + 1, {"c": c, "step": k + 1})
    return c


def main(mesh_prefix: str, num_steps: int = 200, seed: int = 0, device="cuda"):
    """Playground ``main`` analog: load mesh, random init, march, and write
    ten snapshots into the working directory."""
    from stormx_torch.core import print_banner
    from stormx_torch.mesh import read_tetgen

    dev = resolve_device(device)
    print_banner()
    mesh = read_tetgen(mesh_prefix)
    dtype = default_real_dtype()
    dmesh = mesh.device_arrays(dtype=dtype, device=dev)
    rng = np.random.default_rng(seed)
    c0 = torch.as_tensor(0.5 + 0.1 * rng.standard_normal(mesh.num_cells),
                         dtype=dtype, device=dev)
    return run(dmesh, c0, num_steps, mesh=mesh, assembled=True,
               output_every=max(1, num_steps // 10), device=dev)
