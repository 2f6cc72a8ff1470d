"""The plain references against dense matrices assembled here by hand, and
their solves against a dense solve, at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.inputs.grid import poisson5_diags
from portbench.inputs.mesh import delaunay_mesh
from portbench.reference import dia_poisson, fv_diffusion
from portbench.reference.cg import cg


def dense_of(op, n):
    eye = torch.eye(n, dtype=torch.float64)
    return torch.stack([op(eye[k].clone()) for k in range(n)], dim=1).numpy()


def hand_heat(points, tris, tau):
    """V + τ·L assembled triangle pair by triangle pair in plain Python."""
    n = len(tris)
    A = np.zeros((n, n))
    centre = points[tris].mean(axis=1)
    owner = {}
    for c, t in enumerate(tris):
        a, b, d = points[t]
        A[c, c] += 0.5 * abs((b[0] - a[0]) * (d[1] - a[1]) - (b[1] - a[1]) * (d[0] - a[0]))
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            owner.setdefault(tuple(sorted(e)), []).append(c)
    for (p, q), cells in owner.items():
        if len(cells) == 2:
            i, j = cells
            w = tau * np.linalg.norm(points[p] - points[q]) / np.linalg.norm(centre[i] - centre[j])
            A[i, i] += w
            A[j, j] += w
            A[i, j] -= w
            A[j, i] -= w
    return A


def test_heat_operator_is_the_hand_assembly():
    points, tris = delaunay_mesh(6, 0.35, 0)
    op = fv_diffusion.Operator(points, tris, 0.01, "cpu")
    np.testing.assert_allclose(dense_of(op, len(tris)), hand_heat(points, tris, 0.01),
                               rtol=1e-13, atol=1e-16)


def test_poisson_operator_is_the_dia_matrix():
    nx = 5
    offsets, data = poisson5_diags(nx, np.float64)
    n = nx * nx
    A = np.zeros((n, n))
    for d, off in enumerate(offsets):
        for i in range(n):
            if 0 <= i + off < n:
                A[i, i + off] = data[d, i]
    np.testing.assert_array_equal(dense_of(dia_poisson.Operator(nx, "cpu"), n), A)


def test_normalised_residual_by_hand():
    """OpenFOAM's normalised residual, in 2-norms, against a dense count: 0 to
    rounding for the exact step, and by hand for a step left at its start."""
    points, tris = delaunay_mesh(6, 0.35, 0)
    op = fv_diffusion.Operator(points, tris, 0.01, "cpu")
    A = hand_heat(points, tris, 0.01)
    vol = A.sum(axis=1)  # the row sums of V + τ·L are V
    u = np.random.default_rng(0).standard_normal(len(tris))
    exact = np.linalg.solve(A, vol * u)
    assert fv_diffusion.normalised_residual(op, torch.as_tensor(u), torch.as_tensor(exact)) < 1e-12
    pa = u.mean() * vol
    nf = np.linalg.norm(A @ u - pa) + np.linalg.norm(vol * u - pa)
    want = np.linalg.norm(vol * u - A @ u) / nf
    got = fv_diffusion.normalised_residual(op, torch.as_tensor(u), torch.as_tensor(u))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_cg_against_a_dense_solve(dtype, tol):
    nx = 8
    op = dia_poisson.Operator(nx, "cpu", dtype)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(nx * nx)).to(dtype)
    s = cg(op, b, torch.zeros_like(b), op.inv_diag, rtol=1e-12 if dtype == torch.float64 else 1e-6,
           max_iterations=500)
    want = np.linalg.solve(dense_of(dia_poisson.Operator(nx, "cpu"), nx * nx), b.double().numpy())
    np.testing.assert_allclose(s.x.double().numpy(), want, rtol=tol, atol=tol)
    assert s.converged
