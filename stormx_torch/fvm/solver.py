"""Top-level FV solver: wires mesh + convection scheme + BC map
(counterpart of ``stormx/fvm/solver.py``; reference
``Feathers/SkunkFvSolver.hpp:44-102``).

Default BCs {label 1 → FarField, label 2 → Slip} (``:73-74``),
``calc_func`` = convection, ``step`` = forward Euler û = u − dt·f(u).  The
port runs eagerly: a step is a sequence of kernel launches, K3 among them
when the mesh carries its plans, and ``march`` a Python loop over steps that
never reads the device.
"""

from __future__ import annotations

from stormx_torch.fvm.bc import far_field_bc, slip_bc
from stormx_torch.fvm.convection import linear_upwind_convection, upwind_convection
from stormx_torch.fvm.flux import lax_friedrichs_flux
from stormx_torch.fvm.gradient import lsq_gradient_matrices

__all__ = ["FvSolver"]


class FvSolver:
    """Euler-equation finite-volume solver over a :class:`DeviceMesh`."""

    def __init__(self, dmesh, *, bcs=None, order: int = 2, flux_scheme=lax_friedrichs_flux):
        self.dmesh = dmesh
        # Default BC map per the reference (SkunkFvSolver.hpp:73-74).
        self.bcs = bcs if bcs is not None else {1: far_field_bc, 2: slip_bc}
        self.order = order
        self.flux_scheme = flux_scheme
        # LSQ matrices once per mesh (GradientScheme.hpp:50-62).
        self._g_mats = lsq_gradient_matrices(dmesh) if order == 2 else None

    def calc_func(self, u):
        """Spatial discretization f(u) = div·F (SkunkFvSolver.hpp:81-86)."""
        if self.order == 1:
            return upwind_convection(self.dmesh, u, self.bcs, self.flux_scheme)
        return linear_upwind_convection(self.dmesh, u, self.bcs, self.flux_scheme,
                                        g_mats=self._g_mats)

    def step(self, u, dt):
        """Forward Euler û = u − dt·f(u) (SkunkFvSolver.hpp:91-99)."""
        return u - dt * self.calc_func(u)

    def jitted_step(self):
        """The step function, ``self.step`` itself.  The JAX package returns
        ``jax.jit(self.step)``; the port runs eagerly, and wrapping the step
        in ``torch.compile`` would put a generated kernel where the path's
        gathers must be K3."""
        return self.step

    def implicit_step(self, u, dt, *, options=None, axis_name=None):
        """Backward-Euler û = u − dt·f(û) via JFNK (BASELINE config #4):
        solves A(û) = u with A(w) = w + dt·f(w); J·y comes from the
        finite-difference directional derivative of
        :func:`stormx_torch.solvers.jfnk` (reference
        ``Solvers/SolverNewton.hpp:101-173``).  JFNK's δ is ~√ε of the
        dtype, so the default relative tolerance of 1e-10 needs float64.

        Returns the :class:`~stormx_torch.solvers.SolveResult`; ``res.x`` is
        the implicit state û.
        """
        from stormx_torch.solvers import SolverOptions, jfnk, make_operator

        opts = options or SolverOptions(num_iterations=30, absolute_tolerance=0.0,
                                        relative_tolerance=1e-10)
        A = make_operator(lambda w: w + dt * self.calc_func(w))
        return jfnk(A, u, u, options=opts, axis_name=axis_name)

    def march(self, u0, dt, num_steps: int):
        """``num_steps`` forward-Euler steps.  The JAX package runs them as
        one ``lax.scan``; here a Python loop enqueues them and reads nothing
        back from the device."""
        u = u0
        for _ in range(num_steps):
            u = self.step(u, dt)
        return u
