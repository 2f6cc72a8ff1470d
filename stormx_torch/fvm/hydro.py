"""Ideal-gas (γ = 1.4) state transforms, vectorized over faces/cells
(counterpart of ``stormx/fvm/hydro.py``; reference
``Feathers/SkunkHydro.hpp:35-139``).

Conserved vector U = (ρ, ρE, ρvx, ρvy, ρvz), primitive Q = (ρ, p, vx, vy,
vz), flux Fₙ = (ρvₙ, ρHvₙ, ρv vₙ + p n).  Every face/cell state is
converted at once; 2-D normals are zero-padded to 3 components.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["GAMMA", "GasState", "state_from_cons", "state_from_prim", "NUM_VARS"]

GAMMA = 1.4
GAMMA1 = GAMMA - 1.0
NUM_VARS = 5


class GasState(NamedTuple):
    """Batched fluid state (each field shaped (..., ))."""

    rho: torch.Tensor  # density ρ
    p: torch.Tensor  # pressure
    vel: torch.Tensor  # velocity (..., 3)
    vel_n: torch.Tensor  # v·n
    eps: torch.Tensor  # internal energy ε
    nrg: torch.Tensor  # total energy E = ½v² + ε
    ent: torch.Tensor  # enthalpy H = E + p/ρ
    c_snd: torch.Tensor  # sound speed

    def make_cons(self) -> torch.Tensor:
        """U = (ρ, ρE, ρv) (SkunkHydro.hpp:75-86)."""
        return torch.stack(
            [
                self.rho,
                self.rho * self.nrg,
                self.rho * self.vel[..., 0],
                self.rho * self.vel[..., 1],
                self.rho * self.vel[..., 2],
            ],
            dim=-1,
        )

    def make_flux(self, n: torch.Tensor) -> torch.Tensor:
        """Fₙ = (ρvₙ, ρHvₙ, ρv vₙ + p n) (SkunkHydro.hpp:88-101)."""
        rvn = self.rho * self.vel_n
        return torch.stack(
            [
                rvn,
                rvn * self.ent,
                rvn * self.vel[..., 0] + self.p * n[..., 0],
                rvn * self.vel[..., 1] + self.p * n[..., 1],
                rvn * self.vel[..., 2] + self.p * n[..., 2],
            ],
            dim=-1,
        )


def pad3(n: torch.Tensor) -> torch.Tensor:
    """Zero-pad a (..., 2) normal to (..., 3)."""
    if n.shape[-1] == 3:
        return n
    return torch.cat([n, torch.zeros(n.shape[:-1] + (1,), dtype=n.dtype, device=n.device)],
                     dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def state_from_cons(n, cons) -> GasState:
    """(SkunkHydro.hpp:105-117): ρ = U₀, E = U₁/ρ, v = U₂:₅/ρ, p = (γ−1)ρε."""
    n = pad3(n)
    rho = cons[..., 0]
    nrg = cons[..., 1] / rho
    vel = cons[..., 2:5] / rho[..., None]
    vel_n = _dot(vel, n)
    eps = nrg - 0.5 * _dot(vel, vel)
    p = GAMMA1 * rho * eps
    ent = nrg + p / rho
    c_snd = torch.sqrt(GAMMA * p / rho)
    return GasState(rho, p, vel, vel_n, eps, nrg, ent, c_snd)


def state_from_prim(n, prim) -> GasState:
    """(SkunkHydro.hpp:118-128): Q = (ρ, p, v)."""
    n = pad3(n)
    rho = prim[..., 0]
    p = prim[..., 1]
    vel = prim[..., 2:5]
    vel_n = _dot(vel, n)
    eps = p / rho / GAMMA1
    nrg = eps + 0.5 * _dot(vel, vel)
    ent = nrg + p / rho
    c_snd = torch.sqrt(GAMMA * p / rho)
    return GasState(rho, p, vel, vel_n, eps, nrg, ent, c_snd)
