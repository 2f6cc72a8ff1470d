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
    branch_of,
    check_branch,
    decode_word,
    k3_branch,
    vector_bytes,
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
    """A map wider than MAX_CHUNKS windows: the JAX plan gathers it plainly
    and keeps no window; the port's plan keeps the same (empty) JAX fields,
    and its kernel words are the indices themselves on a base of 0, so the
    kernel (and its plain version) still gathers it in one pass."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 100_000, 20_000)
    plan = BandedGatherPlan(idx, 100_000, fixup_frac=0.0001, **CPU)
    jplan = JPlan(idx, 100_000, fixup_frac=0.0001)
    assert plan.xla_fallback and jplan.xla_fallback
    _assert_same_plan(plan, jplan)
    assert plan.word_starts.shape == (-(-idx.size // plan.R),)
    assert not plan.word_starts.any()
    np.testing.assert_array_equal(plan.word[: idx.size].numpy(), idx)
    np.testing.assert_array_equal(decode_word(plan).numpy(), np.asarray(jplan.full_idx))
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
                                      (np.uint8, 1), (np.float32, 5), (np.float32, 10),
                                      (np.float32, 15), (np.float64, 5), (np.int32, 4)])
def test_plain_version_bit_exact_other_itemsizes(dtype, nv, rng):
    """The kernel's scalar and vector branches (itemsizes 1, 2 and 8, nv > 1,
    the FVM widths) have the same plain version: one pass through the words,
    raw values copied."""
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



def test_dispatcher_hands_the_kernel_a_contiguous_field(monkeypatch, rng):
    """Off the CPU the plan hands the kernel entry ``x.contiguous()``: a
    transpose or a column view of a field (the FVM operators gather both)
    arrives contiguous, with its shape.  Tensors on the ``meta`` device take
    the dispatcher's non-CPU branch here, where the kernel entry is replaced
    by a recorder; ``tests/test_torch_kernels.py`` gathers such views on the
    card."""
    import stormx_torch.ops.banded_gather as bg

    idx, n = _idx("sorted", rng)
    plan = BandedGatherPlan(idx, n, **CPU)
    seen = []
    monkeypatch.setattr(bg, "banded_gather_cuda",
                        lambda p, x: seen.append((p, x.is_contiguous(), tuple(x.shape))))
    field = torch.empty((n, 3), device="meta")
    transposed = torch.empty((3, n), device="meta").t()
    for view in (transposed, field[:, 1], field):
        plan(view)
        assert seen[-1] == (plan, True, tuple(view.shape))
    assert not transposed.is_contiguous() and not field[:, 1].is_contiguous()


def test_dispatcher_sends_every_plan_to_the_kernel(monkeypatch):
    """Off the CPU every plan's call is one call of the kernel entry, a map
    wider than MAX_CHUNKS windows (the JAX plan's plain gather) among them:
    the four plans of a tetrahedral box, whose cell←face map is that wide.
    Tensors on the ``meta`` device take the dispatcher's non-CPU branch
    here, where the kernel entry is replaced by a recorder."""
    import stormx_torch.ops.banded_gather as bg
    from stormx_torch.mesh import structured_tet_box

    dm = structured_tet_box(10, 10, 10).optimize_ordering().device_arrays(
        torch.float32, device="cpu", banded_gather=True)
    plans = [getattr(dm, "bg_" + n) for n in ("face_inner", "face_outer", "cell_face",
                                             "cell_adj")]
    assert dm.bg_cell_face.xla_fallback
    seen = []
    monkeypatch.setattr(bg, "banded_gather_cuda", lambda p, x: seen.append(p))
    for plan in plans:
        plan(torch.empty((plan.n_src, 5), device="meta"))
    assert seen == plans


# (nv, itemsize, x address mod 16, R) -> (branch, bytes a move), y and the
# words 16-byte aligned: the FVM widths move their rows as the widest vector
# that divides them (nv 2 and 10 float32 in 8 bytes, nv 3, 5, 15 in 4, nv 4
# in 16), complex128 (itemsize 16) as 16-byte vectors, a base that is only
# 4-byte aligned in 4-byte ones; 1- and 2-byte rows and float32 scalar fields
# keep their branches.
BRANCH_RULE = {
    "f32_nv1": ((1, 4, 0, 512), ("vec4", 16)),
    "f32_nv1_x_at_4": ((1, 4, 4, 512), ("vec4", 16)),
    "f32_nv2": ((2, 4, 0, 512), ("vector", 8)),
    "f32_nv3": ((3, 4, 0, 512), ("vector", 4)),
    "f32_nv4": ((4, 4, 0, 512), ("vector", 16)),
    "f32_nv4_x_at_4": ((4, 4, 4, 512), ("vector", 4)),
    "f32_nv4_x_at_8": ((4, 4, 8, 512), ("vector", 8)),
    "f32_nv5": ((5, 4, 0, 512), ("vector", 4)),
    "f32_nv10": ((10, 4, 0, 512), ("vector", 8)),
    "f32_nv15": ((15, 4, 0, 512), ("vector", 4)),
    "f64_nv1": ((1, 8, 0, 512), ("vector", 8)),
    "f64_nv5": ((5, 8, 0, 512), ("vector", 8)),
    "f64_nv10": ((10, 8, 0, 512), ("vector", 16)),
    "c64_nv2": ((2, 8, 0, 512), ("vector", 16)),
    "c128_nv1": ((1, 16, 0, 512), ("vector", 16)),
    "c128_nv5": ((5, 16, 8, 512), ("vector", 8)),
    "i16_nv1": ((1, 2, 0, 512), ("scalar", 2)),
    "i16_nv2": ((2, 2, 0, 512), ("scalar", 2)),
    "i16_nv4": ((4, 2, 0, 512), ("vector", 8)),
    "i16_nv4_x_at_2": ((4, 2, 2, 512), ("scalar", 2)),
    "u8_nv3": ((3, 1, 0, 512), ("scalar", 1)),
    "f32_nv5_wide_blocks": ((5, 4, 0, 16384), ("scalar", 4)),
}


@pytest.mark.parametrize("case", sorted(BRANCH_RULE))
def test_branch_rule(case):
    (nv, itemsize, x_mod, R), want = BRANCH_RULE[case]
    assert k3_branch(nv, itemsize, R, x_addr=x_mod, y_addr=0, word_addr=0) == want
    # Only the addresses modulo 16 matter, and a forced branch that takes
    # the shape moves the rule's bytes.
    for shift in (16, 4096, 2**40):
        assert k3_branch(nv, itemsize, R, x_addr=x_mod + shift, y_addr=shift,
                         word_addr=shift) == want
    assert check_branch(want[0], nv, itemsize, R, x_addr=x_mod, y_addr=0, word_addr=0) == want[1]


def test_vector_bytes():
    assert vector_bytes(60, 0, 0) == 4 and vector_bytes(40, 0, 0) == 8
    assert vector_bytes(32, 0, 0) == 16 and vector_bytes(32, 8, 0) == 8
    assert vector_bytes(6, 0, 0) == 0 and vector_bytes(16, 2, 0) == 0


@pytest.mark.parametrize("branch,nv,itemsize,x_mod,y_mod,R", [
    ("vec4", 2, 4, 0, 0, 512),     # not a scalar field
    ("vec4", 1, 8, 0, 0, 512),     # not 4-byte components
    ("vec4", 1, 4, 0, 8, 512),     # y not 16-byte aligned
    ("vector", 3, 2, 0, 0, 512),   # 6-byte rows
    ("vector", 4, 4, 2, 0, 512),   # x 2-byte aligned
    ("vector", 4, 4, 0, 0, 16384),  # a source table over 48 KB
    ("rows", 4, 4, 0, 0, 512),     # no such branch
])
def test_check_branch_refuses(branch, nv, itemsize, x_mod, y_mod, R):
    with pytest.raises(ValueError):
        check_branch(branch, nv, itemsize, R, x_addr=x_mod, y_addr=y_mod, word_addr=0)


def test_branch_of_reads_a_field_as_the_wrapper_does(rng):
    """``branch_of`` gives the rule's branch for a field's own nv, itemsize
    and address, with a fresh (16-byte aligned) y, as the wrapper decides
    it; a forced branch that takes the shape moves the rule's bytes, and
    one that does not is refused."""
    idx, n = _idx("sorted", rng)
    plan = BandedGatherPlan(idx, n, **CPU)
    word = plan.word.data_ptr()
    for nv, dtype, want in ((5, torch.float32, "vector"), (1, torch.float32, "vec4"),
                            (3, torch.int16, "scalar"), (2, torch.complex128, "vector")):
        x = torch.zeros((n, nv) if nv > 1 else (n,), dtype=dtype)
        assert branch_of(plan, x) == want
        shape = dict(x_addr=x.data_ptr(), y_addr=0, word_addr=word)
        rule = k3_branch(nv, x.element_size(), plan.R, **shape)
        assert rule[0] == want
        assert check_branch(want, nv, x.element_size(), plan.R, **shape) == rule[1]
        assert check_branch("scalar", nv, x.element_size(), plan.R, **shape) >= 1
    # A field at an offset of one float32 moves 4-byte vectors.
    x = torch.zeros(n * 4 + 1, dtype=torch.float32)[1:].view(n, 4)
    assert x.is_contiguous() and x.data_ptr() % 16 in (4, 12)
    assert branch_of(plan, x) == "vector"
    assert k3_branch(4, 4, plan.R, x_addr=x.data_ptr(), y_addr=0, word_addr=word) == ("vector", 4)
    with pytest.raises(ValueError):
        check_branch("vec4", 4, 4, plan.R, x_addr=x.data_ptr(), y_addr=0, word_addr=word)
