"""Restarted GMRES and FGMRES (Saad) (counterpart of
``stormx/solvers/gmres.py``; reference ``Solvers/SolverGmres.hpp:41-310``):

* restart length m (default 50, ``Solver.hpp:159``);
* modified Gram–Schmidt Arnoldi (``:157-162``), or classical Gram–Schmidt
  with reorthogonalization (``orthog="cgs2"``);
* Givens QR via ``sym_ortho`` (``:176-183``);
* back-substitution in ``inner_finalize`` (``:207-248``) at each restart
  boundary and once more at exit for a partial cycle;
* FGMRES stores zₖ = 𝓟qₖ per iteration and forces right preconditioning
  (``:96-97,128-130``).

The Krylov basis is an (m+1, n) stack updated in place.  The Hessenberg
column, the rotations and β stay on the device; the inner index is a host
integer, so nothing is read back beyond ``run_iterative``'s one
convergence test per iteration.
"""

from __future__ import annotations

import torch

from stormx_torch.ops import safe_divide, sym_ortho
from stormx_torch.ops import vector as v
from stormx_torch.solvers.base import SolveResult, SolverOptions, resolve_side, run_iterative
from stormx_torch.solvers.operator import as_operator
from stormx_torch.solvers.preconditioner import PreconditionerSide, build_preconditioner

__all__ = ["gmres", "fgmres"]


def arnoldi_step(q_new, Q, k: int, H, cs, sn, beta, *, orthog: str, axis_name,
                 safe: bool = False) -> torch.Tensor:
    """One Arnoldi + Givens step, in place: orthogonalize ``q_new`` (the
    operator applied to step k's direction) against ``Q[0..k]``, store it
    normalized in ``Q[k+1]``, rotate the new column of H by the stored
    rotations and a new one (``:157-183``), and update β (``:187-189``).
    ``safe`` divides by ‖q_new‖ through ``safe_divide`` (LGMRES's rule).
    Returns the residual estimate |β(k+1)|."""
    h = torch.zeros(H.shape[0], dtype=beta.dtype, device=beta.device)
    if orthog == "mgs":
        # Modified Gram–Schmidt (:157-162): k+1 sequential dot+axpy pairs.
        for i in range(k + 1):
            hik = v.dot(q_new, Q[i], axis_name=axis_name)
            h[i] = hik
            q_new = v.xpay(q_new, -hik, Q[i])
    else:
        # Two passes of classical Gram–Schmidt, each one stacked dot and
        # one stacked combination over q₀..qₖ.
        for _ in range(2):
            hk = v.dots_stacked(Q[: k + 1], q_new, axis_name=axis_name)
            q_new = v.sub(q_new, v.lincomb_stacked(hk, Q[: k + 1]))
            h[: k + 1] += hk
    hk1 = v.norm_2(q_new, axis_name=axis_name)
    h[k + 1] = hk1
    v.set_stacked(Q, k + 1, v.scale(safe_divide(1.0, hk1) if safe else 1.0 / hk1, q_new))

    # Apply the stored Givens rotations to column k (:176-180).  The unitary
    # rotation is [[conj(cs), conj(sn)], [-sn, cs]]; torch.conj is the
    # identity on real tensors, and for complex operators it keeps the
    # residual estimate |β(k+1)| equal to the true residual norm.
    for i in range(k):
        chi = cs[i].conj() * h[i] + sn[i].conj() * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = chi

    # New rotation, eliminating H(k+1, k) (:181-183).
    cs_k, sn_k, _ = sym_ortho(h[k], h[k + 1])
    h[k] = cs_k.conj() * h[k] + sn_k.conj() * h[k + 1]
    h[k + 1] = 0.0
    cs[k] = cs_k
    sn[k] = sn_k
    H[:, k] = h

    # β-solution update (:187-189); residual estimate = |β(k+1)|, real.
    beta[k + 1] = -sn_k * beta[k]
    beta[k] = cs_k.conj() * beta[k]
    return torch.abs(beta[k + 1])


def back_substitute(H, beta, k: int) -> torch.Tensor:
    """y with H[:k+1, :k+1]·y = β[:k+1], H upper triangular (:194-206)."""
    return torch.linalg.solve_triangular(H[: k + 1, : k + 1], beta[: k + 1, None],
                                         upper=True)[:, 0]


def _base_gmres(op, b, x0, *, flexible: bool, precond, options: SolverOptions | None,
                restart: int, axis_name, orthog: str = "mgs") -> SolveResult:
    if orthog not in ("mgs", "cgs2"):
        raise ValueError(f"unknown orthogonalization {orthog!r}")
    opts = options or SolverOptions()
    m = restart
    A = as_operator(op)
    P = build_preconditioner(precond, x0, b, A)
    side = resolve_side(opts.pre_side, precond=P, solver="gmres")
    # Flexible GMRES forces right preconditioning (SolverGmres.hpp:96-97).
    left_pre = P is not None and not flexible and side == PreconditionerSide.LEFT
    right_pre = P is not None and (flexible or side == PreconditionerSide.RIGHT)
    store_z = flexible and P is not None

    def norm(x):
        return v.norm_2(x, axis_name=axis_name)

    def make_q0(x):
        """q₀ ← 𝓟?(b − 𝓐x); β₀ ← ‖q₀‖; q₀ /= β₀ (:72-91,100-117)."""
        q0 = A.residual(b, x)
        if left_pre:
            q0 = P(q0)
        beta0 = norm(q0)
        return v.scale(1.0 / beta0, q0), beta0

    def init_fn(x):
        q0, beta0 = make_q0(x)
        Q = v.set_stacked(v.stacked_zeros(q0, m + 1), 0, q0)
        Z = v.stacked_zeros(q0, m) if store_z else None
        small = dict(dtype=q0.dtype, device=q0.device)
        H = torch.zeros((m + 1, m), **small)
        cs = torch.zeros(m, **small)
        sn = torch.zeros(m, **small)
        beta = torch.zeros(m + 1, **small)
        beta[0] = beta0
        return (Q, Z, H, cs, sn, beta), beta0

    def inner_iterate(k, x, state):
        Q, Z, H, cs, sn, beta = state
        q_k = Q[k]

        # New Krylov vector (:132-156).
        if left_pre:
            q_new = P(A(q_k))
        elif right_pre:
            z = P(q_k)
            q_new = A(z)
            if store_z:
                v.set_stacked(Z, k, z)
        else:
            q_new = A(q_k)
        err = arnoldi_step(q_new, Q, k, H, cs, sn, beta, orthog=orthog, axis_name=axis_name)
        return x, (Q, Z, H, cs, sn, beta), err

    def inner_finalize(k, x, state):
        """Back-substitute H·y = β and fold the correction into x (:194-248)."""
        Q, Z, H, cs, sn, beta = state
        y = back_substitute(H, beta, k)
        if not right_pre:
            return v.add(x, v.lincomb_stacked(y, Q[: k + 1]))
        if store_z:
            return v.add(x, v.lincomb_stacked(y, Z[: k + 1]))
        return v.add(x, P(v.lincomb_stacked(y, Q[: k + 1])))

    def iterate_fn(it, x, state):
        j = it % m
        # inner_init at restart boundaries (Solver.hpp:239-242); the first
        # cycle's is the outer init.
        if j == 0 and it > 0:
            Q, Z, H, cs, sn, beta = state
            q0, beta0 = make_q0(x)
            v.set_stacked(Q, 0, q0)
            beta[0] = beta0
        x, state, err = inner_iterate(j, x, state)
        if j == m - 1:  # inner_finalize at cycle end (Solver.hpp:244-246)
            x = inner_finalize(j, x, state)
        return x, state, err

    def finalize_fn(it, x, state):
        # Solver.hpp:250-257: finalize a partial cycle at exit.
        j_last = (it - 1) % m
        return x if j_last == m - 1 else inner_finalize(j_last, x, state)

    return run_iterative(init_fn, iterate_fn, finalize_fn, x0, opts)


def gmres(op, b, x0, *, precond=None, options: SolverOptions | None = None,
          restart: int = 50, axis_name=None, orthog: str = "mgs") -> SolveResult:
    """Restarted GMRES (``SolverGmres.hpp:282-283``).  ``orthog``: "mgs"
    (the reference's scheme) or "cgs2" (two classical passes, each one
    stacked dot product)."""
    return _base_gmres(op, b, x0, flexible=False, precond=precond, options=options,
                       restart=restart, axis_name=axis_name, orthog=orthog)


def fgmres(op, b, x0, *, precond=None, options: SolverOptions | None = None,
           restart: int = 50, axis_name=None, orthog: str = "mgs") -> SolveResult:
    """Flexible GMRES (``SolverGmres.hpp:308-310``): right preconditioning
    only; zₖ stored per iteration so 𝓟 may vary between iterations."""
    return _base_gmres(op, b, x0, flexible=True, precond=precond, options=options,
                       restart=restart, axis_name=axis_name, orthog=orthog)
