"""Kernel K3's plan and plain version (stormx_torch.ops.banded_gather) held
against the JAX package's BandedGatherPlan: identical host arrays, and
outputs bit-exact against the JAX plan in interpret mode and against
``x[idx]``, for ``(n,)`` and ``(n, nv)`` inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.ops.pallas_gather import BandedGatherPlan as JPlan
from stormx_torch.ops.banded_gather import (
    BandedGatherPlan,
    banded_gather_cuda,
    banded_gather_plain,
)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _idx(kind, rng):
    if kind == "sorted":
        return np.sort(rng.integers(0, 5000, 11000)), 5000
    if kind == "outliers":
        idx = np.sort(rng.integers(0, 5000, 11000))
        idx[::977] = rng.integers(0, 5000, len(idx[::977]))
        return idx, 5000
    if kind == "random":
        return rng.integers(0, 5000, 3000), 5000
    if kind == "tiny":
        return np.sort(rng.integers(0, 5000, 127)), 5000
    if kind == "one":
        return np.array([4321]), 5000
    raise ValueError(kind)


KINDS = ["sorted", "outliers", "random", "tiny", "one"]
HOST_FIELDS = ("m", "n_src", "R", "window", "sub", "n_chunks", "src_rows", "xla_fallback")
ARRAY_FIELDS = ("starts", "lidx", "fix_pos", "fix_idx")


def _assert_same_plan(tp, jp):
    for name in HOST_FIELDS:
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_host_arrays_identical(kind, rng):
    idx, n = _idx(kind, rng)
    _assert_same_plan(BandedGatherPlan(idx, n), JPlan(idx, n))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_bit_exact(kind, rng):
    idx, n = _idx(kind, rng)
    plan, jplan = BandedGatherPlan(idx, n), JPlan(idx, n)
    x = rng.standard_normal(n).astype(np.float32)
    y = _np(plan(torch.as_tensor(x)))
    assert y.dtype == np.float32
    assert np.array_equal(y, x[idx])
    assert np.array_equal(y, np.asarray(jplan(jnp.asarray(x), interpret=True)))
    xv = rng.standard_normal((n, 3))
    yv = _np(banded_gather_plain(plan, torch.as_tensor(xv)))
    assert np.array_equal(yv, xv[idx])
    assert np.array_equal(yv, np.asarray(jplan(jnp.asarray(xv), interpret=True)))


def test_wide_map_falls_back_to_plain_gather():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 100_000, 20_000)
    plan = BandedGatherPlan(idx, 100_000, fixup_frac=0.0001)
    jplan = JPlan(idx, 100_000, fixup_frac=0.0001)
    assert plan.xla_fallback and jplan.xla_fallback
    _assert_same_plan(plan, jplan)
    np.testing.assert_array_equal(_np(plan.full_idx), np.asarray(jplan.full_idx))
    x = rng.standard_normal(100_000).astype(np.float32)
    assert np.array_equal(_np(plan(torch.as_tensor(x))), x[idx])
    x2 = rng.standard_normal((100_000, 2)).astype(np.float32)
    assert np.array_equal(_np(plan(torch.as_tensor(x2))), x2[idx])


def test_mesh_face_maps():
    from stormx_torch.mesh import structured_tri_rect

    m = structured_tri_rect(40, 32).optimize_ordering()
    x = np.random.default_rng(3).standard_normal(m.num_cells).astype(np.float32)
    for idx in (m.face_cells[:, 0], np.where(m.face_cells[:, 1] >= 0, m.face_cells[:, 1],
                                             m.face_cells[:, 0])):
        plan = BandedGatherPlan(idx, m.num_cells)
        _assert_same_plan(plan, JPlan(idx, m.num_cells))
        assert np.array_equal(_np(plan(torch.as_tensor(x))), x[idx])


def test_bad_inputs():
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([[1, 2]]), 10)
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([10]), 10)
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([1]), 10, block_rows=100)
    with pytest.raises(ValueError):  # the kernel wrapper refuses CPU tensors
        banded_gather_cuda(BandedGatherPlan(np.array([1, 2]), 10), torch.zeros(10))
