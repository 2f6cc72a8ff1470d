"""Plain reference of the Cahn–Hilliard playground's implicit step on a
triangle mesh (StormRuler ``source_apps/playground/Playground.cpp``).

From the raw mesh (points and triangles) alone, through the edges, areas and
two-point weights of :class:`portbench.reference.fv_diffusion.Operator`: the
div-grad (D·x)ᵢ = Σ_e w_e (xⱼ − xᵢ) / Vᵢ over the cell's interior edges, w_e =
|edge| / |cᵢ − cⱼ| (no flux through the boundary).  A step from c solves
A·c' = c − z with A = I − τσ·D + τΓ·D², applied as D twice, and the affine
constant z = −τ·D(f(c) − σc), f(c) = 2c(c − 1)(2c − 1).

Plain PyTorch on any device; imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.cg import cg
from portbench.reference.fv_diffusion import Operator as _Edges


def dF_dc(c: torch.Tensor) -> torch.Tensor:
    """The double well's derivative, f(c) = 2c(c − 1)(2c − 1)."""
    return 2.0 * c * (c - 1.0) * (2.0 * c - 1.0)


class Step:
    """D and A of a triangle mesh and the step's right-hand side, in ``dtype``."""

    def __init__(self, points, tris, config: dict, device, dtype=torch.float64):
        edges = _Edges(points, tris, 1.0, device, dtype)
        self.w, self.i, self.j, self.volume = edges.w, edges.i, edges.j, edges.volume
        self.n = edges.n
        self.tau, self.gamma, self.sigma = config["tau"], config["gamma"], config["sigma"]

    def D(self, x: torch.Tensor) -> torch.Tensor:
        flux = self.w * (x[self.j] - x[self.i])
        y = torch.zeros_like(x)
        y.index_add_(0, self.i, flux)
        y.index_add_(0, self.j, -flux)
        return y / self.volume

    def A(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.D(x)
        return x - self.tau * self.sigma * dx + self.tau * self.gamma * self.D(dx)

    def rhs(self, c: torch.Tensor) -> torch.Tensor:
        """c − z, z = −τ·D(f(c) − σc) the affine constant."""
        return c + self.tau * self.D(dF_dc(c) - self.sigma * c)


def check(fixed: dict, inputs, samples: list, config: dict, traffic: dict,
          device) -> dict:
    """The compared numbers of a run, each the largest over the sampled steps
    (cycle, k) from c to c', in float64:

    - ``ch_res``, the residual ‖(c − z) − A·c'‖₂;
    - ``ch_mass``, the step's relative change of mass |Σ V·(c' − c)| / Σ V·c.
      The scheme conserves mass (Σᵢ Vᵢ (D·x)ᵢ = 0 for every x), and so does
      each iterate of CG from c, whose search directions all carry none;
      unlike the residual, it does not see c' rounded to the state's precision.

    The first step of a cycle starts from the raw c₀ (``inputs(cycle)``), a
    later one from the program's own previous state, kept with the step."""
    step = Step(fixed["points"], fixed["triangles"], config, device)
    volume = step.volume
    res = mass = 0.0
    for (cycle, slot), (c, c_next) in samples:
        if slot == 0:
            c = inputs(cycle)["c0"]
        c, c_next = c.to(torch.float64), c_next.to(torch.float64)
        res = max(res, float(torch.linalg.vector_norm(step.rhs(c) - step.A(c_next))))
        m0 = torch.dot(volume, c)
        mass = max(mass, float(torch.abs(torch.dot(volume, c_next) - m0) / m0))
    return {"ch_res": res, "ch_mass": mass}


class Control:
    """The reference in the program's place: the same march, each step
    solved by :func:`cg` with no preconditioner to the cell's tolerances in
    ``dtype``."""

    def __init__(self, fixed: dict, config: dict, traffic: dict, device, dtype):
        self.step = Step(fixed["points"], fixed["triangles"], config, device, dtype)
        self.config, self.max_iterations = config, config["max_iterations"]
        self.cycle_len = traffic["steps_per_cycle"]
        self.dtype, self.device = dtype, device
        self.ones = torch.ones(self.step.n, device=device, dtype=dtype)
        self.info, self.setup_times = {}, {}

    def load(self, inputs) -> None:
        self.inputs = inputs

    def begin_cycle(self, cycle: int) -> None:
        self.cycle, self.slot = cycle, 0
        self.c = self.inputs(cycle)["c0"].to(self.dtype)

    def solve_next(self):
        c = self.c
        s = cg(self.step.A, self.step.rhs(c), c, self.ones, rtol=self.config["rtol"],
               atol=self.config["atol"], max_iterations=self.max_iterations)
        key, answer = (self.cycle, self.slot), (c, s.x)
        self.c = s.x
        self.slot += 1
        return key, answer, s.iterations, s.converged

    def to_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)

    def counters(self) -> dict:
        return {}

    def free(self) -> None:
        self.step = self.c = self.inputs = None
