"""Plain reference of the implicit diffusion step on a triangle mesh.

From the raw mesh (points and triangles) alone: cell areas V, barycentres,
and for each edge shared by two triangles the two-point-flux weight
w = |edge| / |c₁ − c₂|.  The step operator is A = V + τ·L with
(L·x)ᵢ = Σ_e w_e (xᵢ − xⱼ) over the cell's interior edges (no flux
through the boundary).  A backward-Euler step solves A·u' = V·u, to a
tolerance on OpenFOAM's normalised residual (:func:`normalised_residual`).

Plain PyTorch on any device; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.cg import cg

class Operator:
    """A = V + τ·L of a triangle mesh, applied in ``dtype``."""

    def __init__(self, points: np.ndarray, tris: np.ndarray, tau: float, device,
                 dtype=torch.float64):
        p = np.asarray(points, dtype=np.float64)
        t = np.asarray(tris, dtype=np.int64)
        a, b, c = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
        area = 0.5 * np.abs((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
        centre = (a + b + c) / 3.0
        # Each triangle's three edges as sorted node pairs; an edge met twice
        # joins the two triangles that hold it.
        nodes = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1)
        owner = np.tile(np.arange(len(t)), 3)
        order = np.lexsort((nodes[:, 1], nodes[:, 0]))
        nodes, owner = nodes[order], owner[order]
        twin = np.nonzero((nodes[1:] == nodes[:-1]).all(axis=1))[0]
        i, j = owner[twin], owner[twin + 1]
        length = np.linalg.norm(p[nodes[twin, 0]] - p[nodes[twin, 1]], axis=1)
        w = tau * length / np.linalg.norm(centre[i] - centre[j], axis=1)
        diag = area.copy()
        np.add.at(diag, i, w)
        np.add.at(diag, j, w)
        self.n = len(t)
        self.edges = len(twin)
        self.dtype = dtype

        def dev(x, dt=dtype):
            return torch.as_tensor(x, device=device).to(dt)

        self.volume = dev(area)
        self.w = dev(w)
        self.i = dev(i, torch.int64)
        self.j = dev(j, torch.int64)
        self.inv_diag = dev(1.0 / diag)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        flux = self.w * (x[self.i] - x[self.j])
        y = self.volume * x
        y.index_add_(0, self.i, flux)
        y.index_add_(0, self.j, -flux)
        return y


def normalised_residual(op: Operator, u: torch.Tensor, u_next: torch.Tensor) -> float:
    """‖V·u − A·u'‖ / (‖A·u − A·ū‖ + ‖V·u − A·ū‖) in float64: OpenFOAM's
    residual of the step from u to u' (``lduMatrix::solver::normFactor``),
    in 2-norms, with ū the mean of u and A·ū the uniform field ū under A."""
    u, u_next = u.to(torch.float64), u_next.to(torch.float64)
    b = op.volume * u
    pa = op(torch.full_like(u, float(u.mean())))
    nf = torch.linalg.vector_norm(op(u) - pa) + torch.linalg.vector_norm(b - pa)
    return float(torch.linalg.vector_norm(b - op(u_next)) / nf)


def check(fixed: dict, inputs, samples: list, config: dict, traffic: dict,
          device) -> dict:
    """The compared numbers of a run: ``step_res``, the largest normalised
    residual over the sampled steps (cycle, k) from u to u'.  The first step
    of a cycle starts from the raw u₀ (``inputs(cycle)``), a later one from
    the program's own previous state, kept with the step."""
    op = Operator(fixed["points"], fixed["triangles"], config["tau"], device)
    worst = 0.0
    for (cycle, slot), (u, u_next) in samples:
        if slot == 0:
            u = inputs(cycle)["u0"]
        worst = max(worst, normalised_residual(op, u, u_next))
    return {"step_res": worst}


class Control:
    """The reference in the program's place: the same march, each step
    solved by :func:`cg` to the cell's tolerance in ``dtype``."""

    def __init__(self, fixed: dict, config: dict, traffic: dict, device, dtype):
        self.op = Operator(fixed["points"], fixed["triangles"], config["tau"], device, dtype)
        self.tolerance, self.max_iterations = config["tolerance"], config["max_iterations"]
        self.cycle_len = traffic["steps_per_cycle"]
        self.dtype, self.device = dtype, device
        self.info, self.setup_times = {}, {}

    def load(self, inputs) -> None:
        self.inputs = inputs

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.u = self.inputs(cycle)["u0"].to(self.dtype)

    def solve_next(self):
        u, op = self.u, self.op
        b = op.volume * u
        pa = op(torch.full_like(u, float(u.float().mean())))
        nf = float(torch.linalg.vector_norm((op(u) - pa).float())
                   + torch.linalg.vector_norm((b - pa).float()))
        s = cg(op, b, u, op.inv_diag, atol=self.tolerance * nf,
               max_iterations=self.max_iterations)
        key, answer = (self.cycle, self.slot), (u, s.x)
        self.u = s.x
        self.slot += 1
        return key, answer, s.iterations, s.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        self.op = self.u = self.inputs = None
