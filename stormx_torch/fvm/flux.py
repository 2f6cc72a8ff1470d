"""Numerical flux schemes, vectorized over all faces at once (counterpart
of ``stormx/fvm/flux.py``; reference ``Feathers/FluxScheme.hpp:43-246``).

Lax–Friedrichs (Rusanov): F = ½[(F_r + F_l) − s·(U_r − U_l)], s = max(|vₙ|
+ c).  HLL and HLLC are dormant (``#if 0``) in the reference and live here,
as in the JAX package.  Argument order matches the reference call sites:
r = outer, l = inner.
"""

from __future__ import annotations

import torch

from stormx_torch.fvm.hydro import GAMMA, GasState, pad3, state_from_cons

__all__ = ["lax_friedrichs_flux", "hll_flux", "hllc_flux"]


def lax_friedrichs_flux(n, cons_r, cons_l):
    """Rusanov flux over batched faces (FluxScheme.hpp:56-78)."""
    ur = state_from_cons(n, cons_r)
    ul = state_from_cons(n, cons_l)
    ss = torch.maximum(torch.abs(ur.vel_n) + ur.c_snd, torch.abs(ul.vel_n) + ul.c_snd)
    n3 = pad3(n)
    flux_r = ur.make_flux(n3)
    flux_l = ul.make_flux(n3)
    return 0.5 * ((flux_r + flux_l) - ss[..., None] * (cons_r - cons_l))


def hll_flux(n, cons_r, cons_l):
    """HLL flux (Harten–Lax–van Leer; FluxScheme.hpp:81-160)."""
    ur = state_from_cons(n, cons_r)
    ul = state_from_cons(n, cons_l)
    s_l = torch.minimum(ul.vel_n - ul.c_snd, ur.vel_n - ur.c_snd)
    s_r = torch.maximum(ul.vel_n + ul.c_snd, ur.vel_n + ur.c_snd)
    n3 = pad3(n)
    f_l = ul.make_flux(n3)
    f_r = ur.make_flux(n3)
    sl = s_l[..., None]
    sr = s_r[..., None]
    f_star = (sr * f_l - sl * f_r + sl * sr * (cons_r - cons_l)) / (sr - sl)
    return torch.where(sl >= 0, f_l, torch.where(sr <= 0, f_r, f_star))


def hllc_flux(n, cons_r, cons_l):
    """HLLC flux (Toro §10.4; FluxScheme.hpp:162-246), branch-free.

    Wave speeds follow the reference (pressure-based q-factors, Toro eq.
    10.59-10.62); the star-state energy uses Toro's eq. 10.39, as the JAX
    package does (the reference's dormant code divides by ρ(s_K − s*)).
    """
    n3 = pad3(n)
    ur = state_from_cons(n, cons_r)
    ul = state_from_cons(n, cons_l)

    # Average state and PVRS pressure estimate (Toro 10.61-10.62).
    rho_bar = 0.5 * (ur.rho + ul.rho)
    c_bar = 0.5 * (ur.c_snd + ul.c_snd)
    p_star = torch.clamp(
        0.5 * (ur.p + ul.p) - 0.5 * rho_bar * c_bar * (ur.vel_n - ul.vel_n), min=0.0
    )
    # q-factors (Toro 10.60) and signal speeds (10.59).
    g2 = (GAMMA + 1.0) / (2.0 * GAMMA)
    gp = torch.where(p_star > ur.p, torch.sqrt(1.0 + g2 * (p_star / ur.p - 1.0)), 1.0)
    gm = torch.where(p_star > ul.p, torch.sqrt(1.0 + g2 * (p_star / ul.p - 1.0)), 1.0)
    s_r = ur.vel_n + ur.c_snd * gp
    s_l = ul.vel_n - ul.c_snd * gm

    # Contact speed (Toro 10.37).
    num = (ur.rho * ur.vel_n * (s_r - ur.vel_n) - ur.p) - (
        ul.rho * ul.vel_n * (s_l - ul.vel_n) - ul.p
    )
    den = ur.rho * (s_r - ur.vel_n) - ul.rho * (s_l - ul.vel_n)
    s_s = num / den

    def star_cons(u, s_k):
        # Star-region conserved state (Toro 10.33, 10.39).
        rho_s = u.rho * (s_k - u.vel_n) / (s_k - s_s)
        nrg_s = u.nrg + (s_s - u.vel_n) * (s_s + u.p / (u.rho * (s_k - u.vel_n)))
        vel_s = u.vel + (s_s - u.vel_n)[..., None] * n3
        us = GasState(rho=rho_s, p=u.p, vel=vel_s, vel_n=s_s, eps=u.eps, nrg=nrg_s,
                      ent=u.ent, c_snd=u.c_snd)
        return us.make_cons()

    f_r = ur.make_flux(n3)
    f_l = ul.make_flux(n3)
    f_star_r = f_r + s_r[..., None] * (star_cons(ur, s_r) - cons_r)
    f_star_l = f_l + s_l[..., None] * (star_cons(ul, s_l) - cons_l)

    sl = s_l[..., None]
    sr = s_r[..., None]
    ss = s_s[..., None]
    return torch.where(sr <= 0, f_r,
                       torch.where(sl >= 0, f_l, torch.where(ss <= 0, f_star_r, f_star_l)))
