"""Newton and first-order JFNK nonlinear solvers (counterpart of
``stormx/solvers/newton.py``; reference ``Solvers/SolverNewton.hpp``).

* ``newton``: the caller supplies ``jacobian(x) -> operator``, or forward-mode
  AD provides the exact Jacobian-vector product, ``torch.func.jvp`` of the
  operator where the JAX package takes ``jax.jvp``.  Every kernel on the way
  must have a forward-mode rule: the packed SlicedELL operator has one
  (``ops/sell_packed.py``).  Eager PyTorch evaluates the primal beside the
  tangent, so each Jacobian product costs two operator applications (XLA drops
  the unused primal).  ``line_search="armijo"`` backtracks as in the JAX
  package, as a Python loop with one host read per trial.
* ``jfnk`` (``SolverNewton.hpp:101-173``): the finite-difference product
  J(x)·y ≈ [𝓐(x + δ·y) − 𝓐(x)]/δ with δ = μ·‖y‖⁺, μ = √εₘ·√(1 + ‖x‖) in
  the tensor's dtype, and optional Eisenstat–Walker forcing (``forcing="ew"``).

The inner solver is BiCGStab from t₀ = r at the reference's tolerance of 1e-8
(``:140-157``), which float32 cannot reach: float32 callers pass
``inner_solve`` or use ``forcing="ew"``.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, run_iterative
from stormx_torch.solvers.bicgstab import bicgstab
from stormx_torch.solvers.operator import LinearOperator, as_operator

__all__ = ["newton", "jfnk"]


def _default_inner_options() -> SolverOptions:
    # Inner tolerances from the reference (SolverNewton.hpp:141-142).
    return SolverOptions(absolute_tolerance=1.0e-8, relative_tolerance=1.0e-8,
                         record_history=False)


def newton(op, b, x0, *, jacobian=None, inner_solve=None, options: SolverOptions | None = None,
           axis_name=None, line_search: str | None = None, ls_beta: float = 0.5,
           ls_c: float = 1.0e-4, ls_max: int = 20) -> SolveResult:
    """Newton iterations: solve [∂𝓐(x)/∂x]·t = r, x ← x + λ·t.

    ``jacobian(x)`` returns the linearization of 𝓐 at x as an operator; when
    None, ``torch.func.jvp`` of 𝓐 gives the exact Jacobian-vector product.
    ``line_search="armijo"`` backtracks λ ← β·λ until
    ‖b − 𝓐(x + λt)‖ ≤ (1 − c·λ)·‖r‖ (at most ``ls_max`` times, then the last
    λ is kept); the default takes the full step.
    """
    opts = options or SolverOptions()
    A = as_operator(op)
    inner_opts = _default_inner_options()
    solve_inner = inner_solve or (
        lambda J, r, t0: bicgstab(J, r, t0, options=inner_opts, axis_name=axis_name)
    )
    if line_search not in (None, "armijo"):
        raise ValueError(f"unknown line_search {line_search!r}; use 'armijo'")

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def jac_at(x):
        if jacobian is not None:
            return as_operator(jacobian(x))
        return LinearOperator(lambda y: torch.func.jvp(A, (x,), (y,))[1])

    def init_fn(x):
        w = A(x)
        r = v.sub(b, w)
        return (r, w), norm(r)

    def iterate_fn(it, x, state):
        r, w = state
        t = solve_inner(jac_at(x), r, r).x
        if line_search is None:
            x = v.add(x, t)
            w = A(x)
            r = v.sub(b, w)
            return x, (r, w), norm(r)

        rnorm = norm(r)

        def trial(lam):
            xt = v.xpay(x, lam, t)
            wt = A(xt)
            rt = v.sub(b, wt)
            return xt, wt, rt, norm(rt)

        lam = torch.ones_like(rnorm)
        xt, wt, rt, rn = trial(lam)
        k = 0
        while k < ls_max and bool(rn > (1.0 - ls_c * lam) * rnorm):  # one host read
            lam = lam * ls_beta
            xt, wt, rt, rn = trial(lam)
            k += 1
        return xt, (rt, wt), rn

    return run_iterative(init_fn, iterate_fn, None, x0, opts)


def jfnk(op, b, x0, *, inner_solve=None, options: SolverOptions | None = None, axis_name=None,
         forcing: str | None = None, forcing_gamma: float = 0.9, forcing_alpha: float = 2.0,
         forcing_eta_max: float = 0.9) -> SolveResult:
    """First-order Jacobian-free Newton–Krylov (``SolverNewton.hpp:101-173``).

    ``forcing="ew"`` sets the inner BiCGStab's relative tolerance to the
    Eisenstat–Walker choice-2 η_k = γ·(‖r_k‖/‖r_{k−1}‖)^α, raised to
    γ·η_{k−1}^α where that exceeds 0.1, clamped to [1e-10, η_max], and η_max
    on the first step.  η is read to the host once per Newton step.  The
    default keeps the reference's fixed inner tolerance of 1e-8.
    """
    opts = options or SolverOptions()
    A = as_operator(op)
    inner_opts = _default_inner_options()
    if forcing not in (None, "ew"):
        raise ValueError(f"unknown forcing {forcing!r}; use 'ew'")
    solve_inner = inner_solve or (
        lambda J, r, t0: bicgstab(J, r, t0, options=inner_opts, axis_name=axis_name)
    )

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def init_fn(x):
        # w ← 𝓐(x); r ← b − w (:115-123).
        w = A(x)
        r = v.sub(b, w)
        rnorm = norm(r)
        # State carries (residual, 𝓐(x), ‖r_k‖, ‖r_{k−1}‖, η_{k−1}).
        return (r, w, rnorm, rnorm, torch.full_like(rnorm, forcing_eta_max)), rnorm

    def iterate_fn(it, x, state):
        r, w, rnorm_cur, rnorm_old, eta_prev = state
        # μ ← √εₘ·√(1 + ‖x‖) (:135-137), in r's dtype.
        sqrt_eps = torch.sqrt(torch.tensor(torch.finfo(r.dtype).eps, dtype=r.dtype))
        mu = sqrt_eps * torch.sqrt(1.0 + norm(x))

        def jv(y):
            # δ ← μ·‖y‖⁺; z ← [𝓐(x + δ·y) − w]·δ⁺ (:143-156).
            delta = safe_divide(mu, norm(y))
            z = A(v.xpay(x, delta, y))
            return v.scale(safe_divide(1.0, delta), v.sub(z, w))

        if forcing == "ew" and inner_solve is None:
            if it == 0:  # no ratio yet: the cap
                eta = torch.full_like(eta_prev, forcing_eta_max)
            else:
                eta = forcing_gamma * safe_divide(rnorm_cur, rnorm_old) ** forcing_alpha
                guard = forcing_gamma * eta_prev**forcing_alpha
                eta = torch.where(guard > 0.1, torch.maximum(eta, guard), eta)
                eta = torch.clip(eta, 1.0e-10, forcing_eta_max)
            io = SolverOptions(num_iterations=inner_opts.num_iterations, absolute_tolerance=0.0,
                               relative_tolerance=float(eta), record_history=False)
            t = bicgstab(LinearOperator(jv), r, r, options=io, axis_name=axis_name).x
        else:
            eta = eta_prev
            t = solve_inner(LinearOperator(jv), r, r).x
        # x ← x + t; w ← 𝓐(x); r ← b − w (:160-168).
        x = v.add(x, t)
        w = A(x)
        r = v.sub(b, w)
        rnorm_new = norm(r)
        return x, (r, w, rnorm_new, rnorm_cur, eta), rnorm_new

    return run_iterative(init_fn, iterate_fn, None, x0, opts)
