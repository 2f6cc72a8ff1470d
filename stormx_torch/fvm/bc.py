"""Boundary conditions: ghost-state construction per labeled face group
(counterpart of ``stormx/fvm/bc.py``; reference
``Feathers/SkunkFvBC.hpp:40-141``).

FarField copies the inner state, NoSlip replaces the velocity, Slip removes
its normal component.  Each is one vectorized transform of a label group's
faces (a contiguous slice, since faces are label-sorted); each returns a new
tensor and leaves its input as it was.
"""

from __future__ import annotations

import torch

from stormx_torch.fvm.hydro import pad3, state_from_cons

__all__ = ["far_field_bc", "no_slip_bc", "slip_bc"]


def far_field_bc(n, r, cons):
    """Ghost = interior state (SkunkFvBC.hpp:71-90)."""
    return cons


def no_slip_bc(n, r, cons, vel_fn=None):
    """Ghost velocity ← 0 (or prescribed v(r)) (SkunkFvBC.hpp:92-120).  The
    reference keeps the total energy E and re-emits U from (ρ, E, v), and so
    does this."""
    st = state_from_cons(n, cons)
    vel = vel_fn(r) if vel_fn is not None else torch.zeros_like(st.vel)
    st = st._replace(vel=vel, vel_n=torch.zeros_like(st.vel_n))
    return st.make_cons()


def slip_bc(n, r, cons):
    """Ghost velocity ← v − vₙ·n (SkunkFvBC.hpp:122-141)."""
    st = state_from_cons(n, cons)
    vel = st.vel - st.vel_n[..., None] * pad3(n)
    st = st._replace(vel=vel, vel_n=torch.zeros_like(st.vel_n))
    return st.make_cons()
