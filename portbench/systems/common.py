"""What every system under test shares: the timed solve through the port's
``solve``, and the benchmark's own spans around the calls into each layer
(``solve``, ``operator``, ``precond``, ``rhs``), which exist only in a
traced run."""

from __future__ import annotations

import contextlib

import torch

from portbench.harness import synchronize


class ProgramSystem:
    """Base of the port's systems.  A subclass sets ``op``, ``precond`` and
    ``cycle_len`` and defines ``begin_cycle(cycle)``, ``solve_next`` and
    ``to_input``; ``load(inputs)`` takes the function that gives a cycle's
    inputs; ``info`` holds the shapes the byte counts read and
    ``setup_times`` the host seconds of the set-up's stages."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.max_iterations = config["max_iterations"]
        self.info: dict = {}
        self.setup_times: dict = {}
        self.traced = False
        self.op = self.precond = None

    def span(self, name: str):
        if self.traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _operator(self):
        if not self.traced:
            return self.op

        def apply(x):
            with self.span("operator"):
                return self.op.matvec(x)
        return apply

    def _preconditioner(self):
        from stormx_torch.solvers import Preconditioner

        if not self.traced or self.precond is None:
            return self.precond
        system = self

        class Spanned(Preconditioner):
            def __init__(self, inner):
                self.inner = inner

            def build(self, x, b, op):
                self.inner = self.inner.build(x, b, op)
                return self

            def __call__(self, r):
                with system.span("precond"):
                    return self.inner(r)

        return Spanned(self.precond)

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None, atol: float = 0.0):
        """One solve of the cell's method to its tolerance (the
        configuration's ``rtol``, relative to the initial residual, and
        ``atol``), ending in a synchronise."""
        from stormx_torch.solvers import SolverOptions, solve

        opts = SolverOptions(num_iterations=self.max_iterations, absolute_tolerance=atol,
                             relative_tolerance=self.config["rtol"], record_history=False)
        with self.span("solve"):
            res = solve(self._operator(), b, x0, method=self.traffic["method"],
                        precond=self._preconditioner(), options=opts)
            synchronize(self.device)
        return res

    def load(self, inputs) -> None:
        self.inputs = inputs

    def counters(self) -> dict:
        """The port's launch counters, by the benchmark's kernel ids."""
        from stormx_torch.ops import dia, sell_spmv, tri_solve

        return {"k1": sell_spmv.launches,
                "k2a": dia.launches["dia_spmv"] + dia.launches["dia_spmv_dots"],
                "t1": tri_solve.launches["tri_exact"]}

    def free(self) -> None:
        self.op = self.precond = self.inputs = None
