#!/usr/bin/env python3
"""Check and time K3's branches, and variants of its vector branch, on one
CUDA card.

    python3 scripts/torch_k3_variants.py --check      # build, ptxas, bitwise checks
    python3 scripts/torch_k3_variants.py --variants   # time vector-branch variants
    python3 scripts/torch_k3_variants.py              # sweep every branch over nv

``--check`` builds ``stormx_torch/csrc/banded_gather.cu``, prints ptxas's
register, shared-memory and spill lines of every kernel, and launches every
branch that takes each case (``banded_gather.check_branch``) on synthetic
maps (sorted, with many fixup rows, unsorted, one row, a map wider than
``MAX_CHUNKS`` windows) and a mesh's face and cell←face maps, at float32
and float64 nv 1–5, 10, 15, 16, 17 (a runtime L), int32, int16, uint8,
complex64 and complex128, also with x at an odd offset: each held bit for
bit to the plain version.

The sweep (no option) builds the 318,402-cell jittered Delaunay mesh of
``chip_smoke.py`` and times, on its two face plans (face_inner and
face_outer: 477k rows from 318k), every branch that takes each field of nv
= 1..16 components of float32, float64, complex64 and complex128, in turns
(old, new, new, old: the old branch is "scalar", one thread a component,
or "vec4" for the float32 scalar field), warm and flushed by a write of 128 MB, beside
``torch.index_select``, the bound (words, x and y once over 3.35 TB/s) and
an empty kernel's time through the same timer (the timer's floor).  One
JSON line per (plan, nv, dtype) into ``--out`` (``build/k3_sweep.jsonl``
by default), a summary on stdout.

``--variants`` rebuilds the source with the vector branch's threads a block
(``kVectorThreads``) and bytes a thread loads before it stores
(``kBytesInFlight``) edited by text, into ``build/k3_variants/``, and times
each variant's vector branch at the FVM widths on the face_inner plan,
warm and flushed, in turns, beside the package's build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SWEEP_NV = tuple(range(1, 17))
SWEEP_DTYPES = ("float32", "float64", "complex64", "complex128")
CHECK_NV = (1, 2, 3, 4, 5, 10, 15, 16, 17)
# name -> (kVectorThreads, kBytesInFlight); "as_built" is the package's own
# (128, 64).
VARIANTS = {"t128_b32": (128, 32), "t256_b32": (256, 32), "t256_b64": (256, 64),
            "t256_b128": (256, 128), "t512_b32": (512, 32), "t512_b64": (512, 64)}
VARIANT_WIDTHS = (("float32", 2), ("float32", 3), ("float32", 4), ("float32", 5),
                  ("float32", 10), ("float32", 15), ("float64", 2), ("float64", 5),
                  ("float64", 10), ("complex128", 5))


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln
            or "smem" in ln]


def field(torch, shape, dtype, gen, dev, offset: int = 0):
    """A random field of ``shape`` on the card, starting ``offset`` elements
    into its storage (contiguous)."""
    dt = getattr(torch, dtype)
    n = int(np.prod(shape))
    if dt.is_complex:
        v = torch.randn(n, generator=gen, dtype=dt)
    elif dt.is_floating_point:
        v = torch.randn(n, generator=gen, dtype=dt) * 100
    else:
        v = torch.randint(-1000, 1000, (n,), generator=gen).to(dt)
    storage = torch.empty(n + offset, dtype=dt, device=dev)
    x = storage[offset:].view(shape)
    x.copy_(v.view(shape))
    return x


def check_maps(torch, rng):
    from stormx_torch.mesh import structured_tri_rect

    yield "sorted", np.sort(rng.integers(0, 50_000, 110_003)), 50_000
    idx = np.sort(rng.integers(0, 50_000, 110_000))
    idx[::97] = rng.integers(0, 50_000, len(idx[::97]))
    yield "fixups", idx, 50_000
    yield "unsorted", rng.integers(0, 5000, 3000), 5000
    yield "one", np.array([4321]), 5000
    yield "wide", rng.integers(0, 100_000, 20_000), 100_000
    mesh = structured_tri_rect(120, 100).optimize_ordering()
    yield "face_inner", mesh.face_cells[:, 0], mesh.num_cells
    dm = mesh.device_arrays(torch.float32, device="cpu", banded_gather=False)
    yield "cell_face", dm.cell_face_ell.reshape(-1).numpy(), mesh.num_faces


def check(torch, dev) -> int:
    from stormx_torch.ops import _cuda, banded_gather
    from stormx_torch.ops.banded_gather import BandedGatherPlan

    build_s = _cuda.build(["banded_gather"])
    print(json.dumps(dict(build_s=build_s,
                          ptxas=ptxas_lines(_cuda.build_log.get("banded_gather", "")))),
          flush=True)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(dt, nv) for dt in ("float32", "float64") for nv in CHECK_NV]
    cases += [("int32", 4), ("int16", 1), ("int16", 3), ("int16", 4), ("uint8", 1),
              ("uint8", 16), ("complex64", 1), ("complex64", 5), ("complex128", 1),
              ("complex128", 2), ("complex128", 5), ("complex128", 9)]
    failures, rows = [], 0
    for name, idx, n in check_maps(torch, rng):
        plan = BandedGatherPlan(idx, n, device=dev)
        want_idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        for dtype, nv in cases:
            for offset in (0, 1):
                shape = (n,) if nv == 1 else (n, nv)
                x = field(torch, shape, dtype, gen, dev, offset)
                want = x.index_select(0, want_idx)
                plain = banded_gather.banded_gather_plain(plan, x)
                took = {}
                for branch in banded_gather.BRANCHES:
                    try:
                        y = banded_gather.banded_gather_cuda(plan, x, branch=branch)
                    except ValueError:
                        continue
                    torch.cuda.synchronize()
                    took[branch] = bool(torch.equal(y, plain) and torch.equal(y, want))
                rows += 1
                tag = f"{name}/{dtype}/nv{nv}/+{offset}"
                if not took or not all(took.values()):
                    failures.append(dict(case=tag, bit_exact=took))
                print(json.dumps(dict(case=tag, path=banded_gather.branch_of(plan, x),
                                      bit_exact=took)), flush=True)
    print(json.dumps(dict(cases=rows, failures=failures,
                          branch_launches=banded_gather.branch_launches)), flush=True)
    return 1 if failures else 0


def triangle_face_plans(torch, dev) -> dict:
    """The face_inner and face_outer plans of chip_smoke's 318,402-cell
    jittered Delaunay mesh, with their index maps on the card."""
    import tempfile

    from stormx_torch.mesh import read_tetgen
    from stormx_torch.ops.banded_gather import BandedGatherPlan

    pts, tris = cs.delaunay_mesh(cs.GRID_SIDE, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    fc = mesh.face_cells
    maps = {"face_inner": fc[:, 0], "face_outer": np.where(fc[:, 1] >= 0, fc[:, 1], fc[:, 0])}
    return {name: (BandedGatherPlan(idx, mesh.num_cells, device=dev),
                   torch.as_tensor(idx, dtype=torch.int64, device=dev))
            for name, idx in maps.items()}


def bound(plan, x) -> tuple:
    row = x[0].numel() * x.element_size()
    return cs.bound_ms(4.0 * plan.m + row * (plan.m + plan.n_src), 0.0)


def in_turns(torch, fns: dict, flush) -> dict:
    """Each function timed warm and flushed, in turns forward and backward;
    the mean of its two turns, and the turns."""
    order = list(fns) + list(fns)[::-1]
    times = {k: dict(ms=[], ms_l2_flushed=[]) for k in fns}
    for k in order:
        times[k]["ms"].append(cs.time_ms(torch, fns[k]))
        times[k]["ms_l2_flushed"].append(cs.time_ms(torch, fns[k], flush=flush))
    return {k: dict(ms=statistics.mean(t["ms"]), ms_l2_flushed=statistics.mean(t["ms_l2_flushed"]),
                    turns=t) for k, t in times.items()}


def timer_floor(torch, dev, flush) -> dict:
    from stormx_torch.ops import banded_gather

    empty = lambda: banded_gather.empty_launch(1, dev)  # noqa: E731
    return dict(ms=cs.time_ms(torch, empty), ms_l2_flushed=cs.time_ms(torch, empty, flush=flush))


def sweep(torch, dev, out_path: str) -> int:
    from stormx_torch.ops import _cuda, banded_gather

    _cuda.build(["banded_gather"])
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)
    plans = triangle_face_plans(torch, dev)
    gen = torch.Generator(device="cpu").manual_seed(13)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    floor = timer_floor(torch, dev, flush)
    summary = []
    with open(out_path, "w") as out:
        out.write(json.dumps(dict(timer_floor=floor, device=cs.nvidia_smi())) + "\n")
        for name, (plan, idx) in plans.items():
            for dtype in SWEEP_DTYPES:
                for nv in SWEEP_NV:
                    x = field(torch, (plan.n_src,) if nv == 1 else (plan.n_src, nv), dtype,
                              gen, dev)
                    want = x.index_select(0, idx)
                    fns = {}
                    for branch in ("vec4", "scalar", "vector"):  # old first
                        try:
                            y = banded_gather.banded_gather_cuda(plan, x, branch=branch)
                        except ValueError:
                            continue
                        if not torch.equal(y, want):
                            raise RuntimeError(f"{branch} differs from x[idx] on {name} "
                                               f"{dtype} nv {nv}")
                        fns[branch] = lambda b=branch: banded_gather.banded_gather_cuda(
                            plan, x, branch=b)
                    times = in_turns(torch, fns, flush)
                    b_ms, b_by = bound(plan, x)
                    row = dict(plan=name, m=plan.m, n_src=plan.n_src, dtype=dtype, nv=nv,
                               row_bytes=x[0].numel() * x.element_size(),
                               path=banded_gather.branch_of(plan, x), bound_ms=b_ms,
                               bound_by=b_by, index_select_ms=cs.time_ms(
                                   torch, lambda: torch.index_select(x, 0, idx)),
                               index_select_ms_l2_flushed=cs.time_ms(
                                   torch, lambda: torch.index_select(x, 0, idx), flush=flush),
                               **times)
                    out.write(json.dumps(row) + "\n")
                    out.flush()
                    summary.append({k: (round(v["ms"] * 1e3, 2), round(v["ms_l2_flushed"] * 1e3, 2))
                                    for k, v in times.items()}
                                   | dict(case=f"{name}/{dtype}/nv{nv}", path=row["path"],
                                          index_select_us=round(row["index_select_ms"] * 1e3, 2),
                                          bound_us=round(b_ms * 1e3, 2)))
    print(json.dumps(dict(timer_floor=floor)), flush=True)
    for s in summary:
        print(json.dumps(s), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


def build_variants() -> dict:
    """One library of csrc/banded_gather.cu per variant, built together into
    build/k3_variants/; name -> (ctypes library, nvcc's ptxas lines)."""
    from stormx_torch.ops import _cuda

    src = open(os.path.join(REPO, "stormx_torch", "csrc", "banded_gather.cu")).read()
    out_dir = os.path.join(REPO, "build", "k3_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (threads, in_flight) in VARIANTS.items():
        text, n1 = re.subn(r"constexpr int kVectorThreads = \d+;",
                           f"constexpr int kVectorThreads = {threads};", src)
        text, n2 = re.subn(r"constexpr int kBytesInFlight = \d+;",
                           f"constexpr int kBytesInFlight = {in_flight};", text)
        if n1 != 1 or n2 != 1:
            raise RuntimeError("the variant patterns no longer match csrc/banded_gather.cu")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        for entry, argtypes in _cuda.ENTRIES["banded_gather"].items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        lib.stormx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.stormx_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, [ln for ln in ptxas_lines(log) if "spill" in ln or "registers" in ln])
    return libs


def variant_launch(torch, lib, plan, x, y, vec: int) -> None:
    from stormx_torch.ops import _cuda

    nv = 1 if x.dim() == 1 else x.shape[1]
    rc = lib.stormx_banded_gather(plan.word_starts.data_ptr(), plan.word.data_ptr(),
                                  x.data_ptr(), y.data_ptr(), plan.m, plan.R, nv,
                                  x.element_size(), 1, vec,
                                  torch.cuda.current_stream().cuda_stream)
    _cuda.check(lib, rc, "variant")


def variants(torch, dev) -> int:
    from stormx_torch.ops import _cuda, banded_gather

    _cuda.build(["banded_gather"])
    libs = build_variants()
    print(json.dumps(dict(ptxas={k: v[1] for k, v in libs.items()})), flush=True)
    flush = torch.empty(64 * 2**20 // 4 * 2, dtype=torch.float32, device=dev)
    plan, idx = triangle_face_plans(torch, dev)["face_inner"]
    gen = torch.Generator(device="cpu").manual_seed(3)
    print(json.dumps(dict(timer_floor=timer_floor(torch, dev, flush))), flush=True)
    for dtype, nv in VARIANT_WIDTHS:
        x = field(torch, (plan.n_src, nv), dtype, gen, dev)
        want = x.index_select(0, idx)
        vec = banded_gather.check_branch("vector", nv, x.element_size(), plan.R,
                                         x_addr=x.data_ptr(), y_addr=0, word_addr=0)
        fns = {"as_built": lambda: banded_gather.banded_gather_cuda(plan, x, branch="vector"),
               "scalar": lambda: banded_gather.banded_gather_cuda(plan, x, branch="scalar")}
        for name, (lib, _) in libs.items():
            y = torch.empty_like(want)
            variant_launch(torch, lib, plan, x, y, vec)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"variant {name} differs from x[idx] at {dtype} nv {nv}")
            fns[name] = lambda lib=lib, y=y: variant_launch(torch, lib, plan, x, y, vec)
        times = in_turns(torch, fns, flush)
        b_ms, _ = bound(plan, x)
        print(json.dumps(dict(dtype=dtype, nv=nv, vec_bytes=vec, bound_us=b_ms * 1e3,
                              index_select_us=cs.time_ms(
                                  torch, lambda: torch.index_select(x, 0, idx)) * 1e3,
                              us={k: (round(v["ms"] * 1e3, 2), round(v["ms_l2_flushed"] * 1e3, 2))
                                  for k, v in times.items()})), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="build, print ptxas, check every branch bit for bit")
    parser.add_argument("--variants", action="store_true",
                        help="time variants of the vector branch's constants")
    parser.add_argument("--out", default=os.path.join(REPO, "build", "k3_sweep.jsonl"),
                        help="the sweep's JSON lines")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k3_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.check:
        return check(torch, dev)
    if args.variants:
        return variants(torch, dev)
    return sweep(torch, dev, args.out)


if __name__ == "__main__":
    sys.exit(main())
