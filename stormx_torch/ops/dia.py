"""K2: the banded (DIA) SpMV and the fused CG update (counterpart of
``stormx/ops/pallas_dia.py``).

* K2a, ``csrc/dia_spmv.cu``: ``z = A·x`` (:func:`dia_spmv`), and ``(z, ⟨p,z⟩)``
  in the same pass (:func:`dia_spmv_dots`).
* K2b, ``csrc/cg_update.cu``: ``x′ = x + α·p``, ``r′ = r − α·z`` and
  ``⟨r′,r′⟩`` in one pass (:func:`cg_fused_update`).
* :func:`cg_step` composes them into one unpreconditioned CG iteration.

Each public function launches its kernel for tensors on the card and takes
its plain PyTorch version only for tensors on the CPU.  The kernels take
float32 or float64, the same for every operand.  They add the diagonals in
offset order with FMAs, where the plain version rounds each product, so z
agrees with it to about one rounding per diagonal.  Their dot products are
deterministic tree sums: they agree with ``torch.dot`` to roundoff, not bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch

from stormx_torch.ops.math import safe_divide

__all__ = [
    "dia_spmv",
    "dia_spmv_dots",
    "cg_fused_update",
    "cg_step",
    "dia_spmv_plain",
    "dia_spmv_dots_plain",
    "cg_fused_update_plain",
    "dia_spmv_cuda",
    "dia_spmv_dots_cuda",
    "cg_fused_update_cuda",
]

# Kernel launches of this process, by wrapper; only the *_cuda functions add to them.
launches = {"dia_spmv": 0, "dia_spmv_dots": 0, "cg_fused_update": 0}

MAX_DIAGS = 64  # Offsets struct of csrc/dia_spmv.cu
_THREADS = 256  # kThreads of csrc/reduce.cuh
_BLOCKS_PER_SM = 8  # 2,048 resident threads per SM


# -- plain versions ----------------------------------------------------------


def dia_spmv_plain(dia, x: torch.Tensor) -> torch.Tensor:
    """Plain version: one shifted elementwise FMA per stored diagonal over
    x padded with zeros, ``y[i] = Σ_d data[d, i] · x[i + offsets[d]]``."""
    n, m = dia.shape
    lo = max(0, -min(dia.offsets))
    hi = max(0, n + max(dia.offsets) - m)
    x_pad = torch.nn.functional.pad(x, (lo, hi)) if (lo or hi) else x
    y = torch.zeros(n, dtype=torch.result_type(dia.data, x), device=x.device)
    for d, off in enumerate(dia.offsets):
        y = y + dia.data[d] * x_pad[lo + off : lo + off + n]
    return y


def dia_spmv_dots_plain(dia, p: torch.Tensor):
    """Plain version of ``(z, ⟨p,z⟩)`` with ``z = A·p``."""
    z = dia_spmv_plain(dia, p)
    return z, torch.dot(p.to(z.dtype), z).to(p.dtype)


def cg_fused_update_plain(alpha, x, r, p, z):
    """Plain version of ``(x + α·p, r − α·z, ⟨r′,r′⟩)``."""
    x2 = x + alpha * p
    r2 = r - alpha * z
    return x2, r2, torch.dot(r2, r2)


# -- kernels -----------------------------------------------------------------


def _blocks(n: int, device: torch.device) -> int:
    """Grid of the grid-stride kernels: one pass of resident blocks at most.
    Fixed for a given n and card, so the two-pass sums are reproducible."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))


def _spmv_cuda(dia, x: torch.Tensor, with_dot: bool):
    from stormx_torch.ops import _cuda

    name = "dia_spmv_dots" if with_dot else "dia_spmv"
    data = dia.data
    n_rows, n_cols = dia.shape
    n_diags = len(dia.offsets)
    if not (x.is_cuda and data.is_cuda):
        raise ValueError(f"{name}_cuda needs CUDA tensors")
    if x.device != data.device:
        raise ValueError("operator and x lie on different devices")
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(
            f"the DIA kernel takes float32 or float64 data and x of one dtype, "
            f"got {data.dtype} and {x.dtype}"
        )
    if not 1 <= n_diags <= MAX_DIAGS:
        raise ValueError(f"the DIA kernel takes 1 to {MAX_DIAGS} diagonals, got {n_diags}")
    if tuple(data.shape) != (n_diags, n_rows) or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous ({n_diags}, {n_rows}) tensor")
    if tuple(x.shape) != (n_cols,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous ({n_cols},) tensor, got {tuple(x.shape)}")
    if with_dot and n_rows != n_cols:
        raise ValueError("⟨p, A·p⟩ needs a square operator")
    z = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    blocks = _blocks(n_rows, x.device)
    partials = dot = None
    if with_dot:
        partials = torch.empty(blocks, dtype=x.dtype, device=x.device)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
    offsets = (ctypes.c_int64 * n_diags)(*dia.offsets)
    lib = _cuda.library("dia_spmv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_dia_spmv(
            data.data_ptr(), x.data_ptr(), z.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if dot is None else dot.data_ptr(),
            n_rows, n_cols, n_diags, offsets, blocks, int(x.dtype == torch.float64), stream,
        )
    _cuda.check(lib, rc, name)
    launches[name] += 1
    return z, dot


def dia_spmv_cuda(dia, x: torch.Tensor) -> torch.Tensor:
    """Launch K2a; raises on what it does not take."""
    return _spmv_cuda(dia, x, with_dot=False)[0]


def dia_spmv_dots_cuda(dia, p: torch.Tensor):
    """Launch K2a with its dot product; raises on what it does not take."""
    return _spmv_cuda(dia, p, with_dot=True)


def cg_fused_update_cuda(alpha, x, r, p, z):
    """Launch K2b; raises on what it does not take.  ``alpha`` may be a
    0-d tensor on the card (read there, with no host sync) or a number."""
    from stormx_torch.ops import _cuda

    vecs = (x, r, p, z)
    if not all(v.is_cuda and v.device == x.device for v in vecs):
        raise ValueError("cg_fused_update_cuda needs x, r, p and z on one CUDA device")
    if x.dtype not in (torch.float32, torch.float64) or any(v.dtype != x.dtype for v in vecs):
        raise ValueError("the CG update kernel takes float32 or float64 vectors of one dtype")
    n = x.shape[0]
    if any(tuple(v.shape) != (n,) or not v.is_contiguous() for v in vecs):
        raise ValueError("x, r, p and z must be contiguous vectors of one length")
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).reshape(())
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    blocks = _blocks(n, x.device)
    partials = torch.empty(blocks, dtype=x.dtype, device=x.device)
    rr = torch.empty((), dtype=x.dtype, device=x.device)
    lib = _cuda.library("cg_update")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.stormx_cg_update(
            alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), z.data_ptr(),
            x_out.data_ptr(), r_out.data_ptr(), partials.data_ptr(), rr.data_ptr(),
            n, blocks, int(x.dtype == torch.float64), stream,
        )
    _cuda.check(lib, rc, "cg_fused_update")
    launches["cg_fused_update"] += 1
    return x_out, r_out, rr


# -- public entry points -----------------------------------------------------


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def dia_spmv(dia, x: torch.Tensor) -> torch.Tensor:
    """z = A·x: K2a for tensors on the card, the plain version on the CPU."""
    if _on_cpu(dia.data, x):
        return dia_spmv_plain(dia, x)
    return dia_spmv_cuda(dia, x)


def dia_spmv_dots(dia, p: torch.Tensor):
    """``(z, ⟨p,z⟩)`` with ``z = A·p`` in one pass over p."""
    if _on_cpu(dia.data, p):
        return dia_spmv_dots_plain(dia, p)
    return dia_spmv_dots_cuda(dia, p)


def cg_fused_update(alpha, x, r, p, z):
    """``(x + α·p, r − α·z, ⟨r′,r′⟩)`` in one pass.  Returns new tensors;
    the inputs are not modified."""
    if _on_cpu(x, r, p, z):
        return cg_fused_update_plain(alpha, x, r, p, z)
    return cg_fused_update_cuda(alpha, x, r, p, z)


def cg_step(dia, x, r, p, gamma):
    """One unpreconditioned CG iteration on a banded operator: K2a with its
    dot product, α on the device, K2b, then ``p′ = r′ + β·p`` in plain
    torch.  Returns ``(x′, r′, p′, γ′)`` with ``γ = ⟨r,r⟩`` carried between
    iterations; no value goes to the host."""
    z, pz = dia_spmv_dots(dia, p)
    alpha = safe_divide(gamma, pz)
    x, r, rr = cg_fused_update(alpha, x, r, p, z)
    beta = safe_divide(rr, gamma)
    p = r + beta * p
    return x, r, p, rr
