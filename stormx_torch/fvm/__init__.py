"""Finite-volume method schemes (counterpart of ``stormx/fvm``; reference
``source/Storm/Feathers/``).  The names of the JAX package's ``stormx.fvm``,
plus the port's ``assemble_divgrad_dia``, ``assemble_laplacian`` and
``hllc_flux``."""

from stormx_torch.fvm.bc import far_field_bc, no_slip_bc, slip_bc
from stormx_torch.fvm.convdiff import (
    assemble_convection_diffusion,
    convection_diffusion_operator,
    face_normal_velocity,
)
from stormx_torch.fvm.convection import linear_upwind_convection, upwind_convection
from stormx_torch.fvm.divgrad import (
    assemble_divgrad,
    assemble_divgrad_dia,
    assemble_laplacian,
    div_grad,
    face_flux_coefficients,
)
from stormx_torch.fvm.field import cell_field, face_field, node_field
from stormx_torch.fvm.flux import hll_flux, hllc_flux, lax_friedrichs_flux
from stormx_torch.fvm.gradient import lsq_gradient_matrices, lsq_gradients
from stormx_torch.fvm.hydro import GAMMA, NUM_VARS, GasState, state_from_cons, state_from_prim
from stormx_torch.fvm.limiter import (
    compute_limiters,
    cubic_limiter,
    cubic_second_limiter,
    dummy_second_limiter,
    minmod_limiter,
    venkatakrishnan_limiter,
)
from stormx_torch.fvm.solver import FvSolver

__all__ = [
    "assemble_convection_diffusion",
    "convection_diffusion_operator",
    "face_normal_velocity",
    "far_field_bc",
    "no_slip_bc",
    "slip_bc",
    "linear_upwind_convection",
    "upwind_convection",
    "assemble_divgrad",
    "assemble_divgrad_dia",
    "assemble_laplacian",
    "div_grad",
    "face_flux_coefficients",
    "cell_field",
    "face_field",
    "node_field",
    "hll_flux",
    "hllc_flux",
    "lax_friedrichs_flux",
    "lsq_gradient_matrices",
    "lsq_gradients",
    "GAMMA",
    "NUM_VARS",
    "GasState",
    "state_from_cons",
    "state_from_prim",
    "compute_limiters",
    "cubic_limiter",
    "cubic_second_limiter",
    "dummy_second_limiter",
    "minmod_limiter",
    "venkatakrishnan_limiter",
    "FvSolver",
]
