"""Kernel K3's plan and plain version (stormx_torch.ops.banded_gather) held
against the JAX package's BandedGatherPlan: identical host arrays, the
kernel's words decoding to exactly ``idx``, and outputs (one pass through
those words) bit-exact against the JAX plan in interpret mode and against
``x[idx]``, for ``(n,)`` and ``(n, nv)`` inputs.  Plans are built on the
CPU (``device="cpu"``); the default is the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stormx.ops.pallas_gather import BandedGatherPlan as JPlan
from stormx_torch.core.exceptions import StormError
from stormx_torch.ops.banded_gather import (
    BandedGatherPlan,
    banded_gather_cuda,
    banded_gather_plain,
    decode_word,
)

CPU = dict(device="cpu")


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
    _assert_same_plan(BandedGatherPlan(idx, n, **CPU), JPlan(idx, n))


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_word_decodes_to_idx(kind, rng):
    idx, n = _idx(kind, rng)
    plan = BandedGatherPlan(idx, n, **CPU)
    assert plan.word.dtype == torch.int32 and plan.word.shape == (plan.starts.numel() * plan.R,)
    np.testing.assert_array_equal(decode_word(plan).numpy(), idx)
    # A negative word marks exactly the plan's fixup rows.
    np.testing.assert_array_equal(np.nonzero(plan.word[: plan.m].numpy() < 0)[0],
                                  plan.fix_pos.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_bit_exact(kind, rng):
    idx, n = _idx(kind, rng)
    plan, jplan = BandedGatherPlan(idx, n, **CPU), JPlan(idx, n)
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
    plan = BandedGatherPlan(idx, 100_000, fixup_frac=0.0001, **CPU)
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
        plan = BandedGatherPlan(idx, m.num_cells, **CPU)
        _assert_same_plan(plan, JPlan(idx, m.num_cells))
        np.testing.assert_array_equal(decode_word(plan).numpy(), idx)
        assert np.array_equal(_np(plan(torch.as_tensor(x))), x[idx])


@pytest.mark.parametrize("dtype,nv", [(np.int16, 1), (np.float32, 2), (np.float64, 3),
                                      (np.uint8, 1)])
def test_plain_version_bit_exact_other_itemsizes(dtype, nv, rng):
    """The kernel's scalar branch (itemsizes 1, 2 and 8, nv > 1) has the same
    plain version: one pass through the words, raw values copied."""
    idx, n = _idx("outliers", rng)
    plan, jplan = BandedGatherPlan(idx, n, **CPU), JPlan(idx, n)
    x = (rng.standard_normal((n, nv)) * 100).astype(dtype)
    y = _np(plan(torch.as_tensor(x)))
    assert y.dtype == x.dtype and np.array_equal(y, x[idx])
    assert np.array_equal(y, np.asarray(jplan(jnp.asarray(x), interpret=True)))


@pytest.mark.parametrize("nv", [1, 2, 3])
def test_plain_version_bit_exact_complex128(nv, rng):
    """complex128, whose 16-byte items the kernel moves as two 8-byte words,
    has the same plain version.  The JAX plan in interpret mode refuses
    complex128 on the CPU (Pallas raises NotImplementedError), so the
    reference is ``np.take``; the bits are compared, NaN and −0.0 among
    them."""
    idx, n = _idx("outliers", rng)
    plan = BandedGatherPlan(idx, n, **CPU)
    shape = (n,) if nv == 1 else (n, nv)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x.reshape(-1)[idx[:3]] = [complex(np.nan, -0.0), complex(-0.0, np.inf), 1e-310 - 1e300j]
    y = _np(plan(torch.as_tensor(x)))
    want = np.take(x, idx, axis=0)
    assert y.dtype == np.complex128 and y.shape == want.shape
    assert np.array_equal(y.view(np.uint64), want.view(np.uint64))


def test_bad_inputs():
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([[1, 2]]), 10, **CPU)
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([10]), 10, **CPU)
    with pytest.raises(ValueError):
        BandedGatherPlan(np.array([1]), 10, block_rows=100, **CPU)
    with pytest.raises(ValueError):  # the kernel wrapper refuses CPU tensors
        banded_gather_cuda(BandedGatherPlan(np.array([1, 2]), 10, **CPU), torch.zeros(10))


def test_plan_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; tests/test_torch_kernels.py covers it")
    with pytest.raises(StormError, match="CUDA"):
        BandedGatherPlan(np.arange(10), 10)
