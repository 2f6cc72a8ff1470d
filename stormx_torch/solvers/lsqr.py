"""LSQR and LSMR — rectangular least-squares Krylov solvers (counterpart of
``stormx/solvers/lsqr.py``).

Both run Golub–Kahan bidiagonalization on (𝓐, 𝓐*), so the operator must
provide the conjugate product ``conj_mul`` (``Solvers/Operator.hpp:120-127``);
without it they raise ``StormError``.

* **LSQR** (Paige & Saunders, TOMS 8(1), 1982): CG on the normal equations
  in factored form; monitors the residual estimate ‖b − 𝓐x‖ = |φ̄|.
* **LSMR** (Fong & Saunders, SISC 33(5), 2011): MINRES on the normal
  equations; monitors ‖r‖ through the §5.1 recurrences.

Stopping: the common driver's rule on the residual-norm estimate.  For an
inconsistent system ‖r‖ stalls at min‖b − 𝓐x‖ > 0: give an iteration cap.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide, sym_ortho
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, run_iterative
from stormx_torch.solvers.operator import as_operator, make_operator
from stormx_torch.solvers.preconditioner import build_preconditioner

__all__ = ["lsqr", "lsmr"]


def _normalize(x, axis_name):
    """(x/‖x‖, ‖x‖), with the zero vector mapped to (0, 0)."""
    n = v.norm_2(x, axis_name=axis_name)
    return v.scale(safe_divide(1.0, n), x), n


def lsqr(op, b, x0, *, precond=None, options: SolverOptions | None = None,
         axis_name=None) -> SolveResult:
    """LSQR: min‖b − 𝓐x‖₂ for square or rectangular 𝓐.

    ``precond`` (optional) right-preconditions the factored normal
    equations: it solves min‖b − 𝓐𝓟y‖ and returns x = 𝓟y, so 𝓟 must be
    linear and provide ``conj_apply`` (x0 is taken in y-space).
    """
    opts = options or SolverOptions()
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)

    def amul(x):
        return A(P(x)) if P is not None else A(x)

    def atmul(y):
        z = A.conj_mul(y)
        return P.conj_apply(z) if P is not None else z

    def init_fn(x):
        # β₁u₁ = b − 𝓐x₀;  α₁v₁ = 𝓐*u₁;  w₁ = v₁; φ̄ = β₁; ρ̄ = α₁.
        u, beta = _normalize(v.sub(b, amul(x)), axis_name)
        vv, alpha = _normalize(atmul(u), axis_name)
        return (u, vv, vv, beta, alpha, alpha), beta

    def iterate_fn(it, x, state):
        u, vv, w, phi_bar, rho_bar, alpha = state
        # β u ← 𝓐v − α u;  α v ← 𝓐*u − β v  (Paige–Saunders LSQR 3a-b).
        u, beta = _normalize(v.sub(amul(vv), v.scale(alpha, u)), axis_name)
        vv, alpha = _normalize(v.sub(atmul(u), v.scale(beta, vv)), axis_name)
        # Givens on the lower-bidiagonal column (3c-e).
        cs, sn, rho = sym_ortho(rho_bar, beta)
        theta = sn * alpha
        rho_bar = -cs * alpha
        phi = cs * phi_bar
        phi_bar = sn * phi_bar
        # x ← x + (φ/ρ)w;  w ← v − (θ/ρ)w  (3f-g).
        x = v.axpy(safe_divide(phi, rho), w, x)
        w = v.sub(vv, v.scale(safe_divide(theta, rho), w))
        return x, (u, vv, w, phi_bar, rho_bar, alpha), torch.abs(phi_bar)

    result = run_iterative(init_fn, iterate_fn, None, x0, opts)
    if P is not None:
        # The recurrence accumulated y; map back to x = 𝓟y.
        result = result._replace(x=P(result.x))
    return result


def lsmr(op, b, x0, *, damp: float = 0.0, precond=None,
         options: SolverOptions | None = None, axis_name=None) -> SolveResult:
    """LSMR: min‖b − 𝓐x‖₂ (+ ``damp²``·‖x‖² Tikhonov term) via MINRES on
    the normal equations (Fong–Saunders 2011, Alg. 1 with the §5.1
    residual-norm recurrences).  ``precond`` right-preconditions as in
    :func:`lsqr`.
    """
    opts = options or SolverOptions()
    A_raw = as_operator(op)
    P = build_preconditioner(precond, x0, b, A_raw)
    if P is not None:
        A = make_operator(lambda x: A_raw(P(x)), lambda y: P.conj_apply(A_raw.conj_mul(y)))
    else:
        A = A_raw

    def init_fn(x):
        u, beta = _normalize(v.sub(b, A(x)), axis_name)
        vv, alpha = _normalize(A.conj_mul(u), axis_name)
        zero = torch.zeros_like(beta)
        one = torch.ones_like(beta)
        h = vv
        h_bar = v.zeros_like(vv)
        # (alpha, zetabar, alphabar, rho, rhobar, cbar, sbar, then the ‖r‖
        # recurrence of §5.1: betadd, betad, rhodold, tautildeold,
        # thetatilde, zeta, d)
        flat = (alpha, alpha * beta, alpha, one, one, one, zero,
                beta, zero, one, zero, zero, zero, zero)
        return (u, vv, h, h_bar, flat), beta

    def iterate_fn(it, x, state):
        u, vv, h, h_bar, flat = state
        (alpha, zetabar, alphabar, rho, rhobar, cbar, sbar,
         betadd, betad, rhodold, tautildeold, thetatilde, zeta, d) = flat

        # Golub–Kahan step: β u ← 𝓐v − α u;  α v ← 𝓐*u − β v.
        u, beta = _normalize(v.sub(A(vv), v.scale(alpha, u)), axis_name)
        vv, alpha_new = _normalize(v.sub(A.conj_mul(u), v.scale(beta, vv)), axis_name)

        # Rotation Q̂ folds the damping row into ᾱ; with damp = 0 it is the
        # identity.
        chat, shat, alphahat = sym_ortho(
            alphabar, torch.as_tensor(damp, dtype=alphabar.dtype, device=alphabar.device))
        # Rotation Q turns the lower-bidiagonal B into R.
        rho_old = rho
        c, s, rho = sym_ortho(alphahat, beta)
        thetanew = s * alpha_new
        alphabar = c * alpha_new

        # Rotation Q̄ turns Rᵀ into R̄ (the MINRES part).
        rhobar_old = rhobar
        zeta_old = zeta
        thetabar = sbar * rho
        cbar, sbar, rhobar = sym_ortho(cbar * rho, thetanew)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # Update h̄, x, h.
        h_bar = v.sub(h, v.scale(safe_divide(thetabar * rho, rho_old * rhobar_old), h_bar))
        x = v.axpy(safe_divide(zeta, rho * rhobar), h_bar, x)
        h = v.sub(vv, v.scale(safe_divide(thetanew, rho), h))

        # ‖r‖ estimate (§5.1): rotate the residual recurrences.
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd = -s * betaacute
        thetatildeold = thetatilde
        ctildeold, stildeold, rhotildeold = sym_ortho(rhodold, thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat
        tautildeold = safe_divide(zeta_old - thetatildeold * tautildeold, rhotildeold)
        taud = safe_divide(zeta - thetatilde * tautildeold, rhodold)
        d = d + betacheck * betacheck
        normr = torch.sqrt(d + (betad - taud) ** 2 + betadd * betadd)

        flat = (alpha_new, zetabar, alphabar, rho, rhobar, cbar, sbar,
                betadd, betad, rhodold, tautildeold, thetatilde, zeta, d)
        return x, (u, vv, h, h_bar, flat), normr

    result = run_iterative(init_fn, iterate_fn, None, x0, opts)
    if P is not None:
        result = result._replace(x=P(result.x))
    return result
