#!/usr/bin/env python3
"""T1 ("grid", ``stormx_torch.ops.tri_solve``) on one card, on synthetic
factors, on the mesh factors of ``--sides 50,100,150,200,300`` and of the
smoke's mesh, beside its plain version and earlier versions of its kernel.

    python3 scripts/torch_t1_variants.py [--mesh] [--sides 50,100,...] [--out FILE]
        [--old FILE_OR_REV] [--sweep-warps 1,2,4,8,16,32]

On a CUDA card, from the root of a checkout.  It builds
``csrc/tri_solve.cu``, prints its ptxas lines, the card's name and power
limit and the hops behind T1's latency bound (``l2_chase_ns``,
``flag_hop_ns``), then one JSON line per case:

* a chain of 10⁵ levels (one row each, K = 1);
* synthetic lower factors of about 2.6·10⁵ rows in levels of 10 to 10⁵
  rows, each row reading K = 2 or 7 rows of the levels before it (one of
  them in the level just before), float32 and float64;
* with ``--mesh``, the factors of ``chip_smoke.py``'s phases 20–21 on its
  318,402-cell mesh (IC(0) of V + τ·L, SGS of the Cahn–Hilliard operator,
  ILU(0) of convection–diffusion, IQR's R and Rᵀ), built as those phases
  build them (about two minutes of host); with ``--sides``, the same
  factors on the same kind of mesh from a jittered grid of each side given
  (the smoke's is 400), where the levels are narrower.

Each line holds "grid"'s CUDA-event medians, warm and with L2 flushed by a
128 MB write, whether it agrees bit for bit with the plain version (where
that runs in seconds), its slots a lane and strands (``grid_slots``), and
the least time of its chain of levels (levels × the L2 round trip).  About
a minute without ``--mesh``; redirect the output (``--out``) when it is
longer than the caller keeps.

``--old`` names other ``csrc/tri_solve.cu`` sources, each a file or a git
revision whose copy ``git show`` reads.  Each is built into
``build/t1_old/`` (the second ``build/t1_old2/``, ...) and timed as
"grid_old" ("grid_old2", ...) in every case, in turns with the others, and
held bit for bit to "grid".  Its C entries must take the same arguments as
today's (a probe it lacks is left out), and the launch record it reads
must be a prefix of today's: sources from before T1 had one kernel carry
another record and cannot run here.

``--sweep-warps`` (with ``--mesh``) times "grid" on the IC(0) factors of
the smoke's mesh with their own strands and with the level order dealt out
round robin to each given number of warps an SM, one JSON line each: the
same kernel and rows at each count of resident warps (the contention
between the warps that hold a level's rows and those that spin beside
them), beside what the strands' links save.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_BYTES = 128 * 2**20
SYNTH_ROWS = 1 << 18
WIDTHS = (10, 100, 300, 1_000, 3_000, 10_000, 100_000)


def synthetic(width: int, levels: int, K: int, seed: int, *, device="cpu"):
    """A lower factor of ``levels`` levels of ``width`` rows: every row of
    level l ≥ 1 reads K distinct rows, one in level l − 1, the rest among
    the two levels before it (or all earlier rows when there are fewer)."""
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    n = width * levels
    rows = np.arange(width, n)
    lev = rows // width
    lo = np.maximum(lev - 2, 0) * width
    span = lev * width - lo
    k = np.minimum(K, span)
    first = (lev - 1) * width + rng.integers(0, width, size=len(rows))
    dep_rows, dep_cols = [rows], [first]
    for j in range(1, K):
        take = k > j
        pick = lo[take] + rng.integers(0, span[take])
        dep_rows.append(rows[take])
        dep_cols.append(pick)
    r_all = np.concatenate(dep_rows + [np.arange(n)])
    c_all = np.concatenate(dep_cols + [np.arange(n)])
    key = np.unique(r_all.astype(np.int64) * n + c_all)  # one entry per (row, column)
    r_all, c_all = key // n, key % n
    vals = np.where(r_all == c_all, 2.0 + rng.random(len(key)), 0.5 * rng.standard_normal(len(key)))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, r_all + 1, 1)
    return build_triangular(np.cumsum(rp), c_all, vals, n, lower=True, device=device)


def chain(n: int, seed: int, *, device="cpu"):
    from stormx_torch.precond import build_triangular

    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = np.concatenate([1.0 + rng.random(n), -0.9 * rng.random(n - 1)])
    order = np.lexsort((cols, rows))
    rp = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rp, rows + 1, 1)
    return build_triangular(np.cumsum(rp), cols[order], vals[order], n, lower=True,
                            device=device)


def mesh_factors(torch, dev, cs, side):
    """{name: (factor, lower)} of chip_smoke.py's phases 20–21 on the mesh of
    a jittered grid of ``side`` points a side, float32."""
    from stormx_torch.apps.cahn_hilliard import make_assembled_step
    from stormx_torch.fvm import assemble_convection_diffusion
    from stormx_torch.fvm.divgrad import assemble_laplacian
    from stormx_torch.mesh import read_tetgen
    from stormx_torch.precond import (IcPreconditioner, IluPreconditioner, IqrPreconditioner,
                                      SgsPreconditioner)
    from stormx_torch.sparse.formats import CSR
    from stormx_torch.sparse.windowed import auto_operator

    pts, tris = cs.delaunay_mesh(side, cs.JITTER, seed=0)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        prefix = os.path.join(tmp, "delaunay.1.")
        cs.write_tetgen(prefix, pts, tris)
        mesh = read_tetgen(prefix).optimize_ordering()
    step = make_assembled_step(mesh, dtype=torch.float32, device=dev)
    lc = assemble_laplacian(mesh).to_csr()
    c = mesh.cell_centers
    _, perm = auto_operator(CSR(data=lc.data.float(), indices=lc.indices, row_ptr=lc.row_ptr,
                                shape=lc.shape), coords=c, device=dev)
    cd = assemble_convection_diffusion(mesh, cs.rotating_velocity, cs.CONVDIFF_EPS).to_csr()
    cd_op, cd_perm = auto_operator(CSR(data=cd.data.float(), indices=cd.indices,
                                       row_ptr=cd.row_ptr, shape=cd.shape), coords=c, device=dev)
    ops = cs.precond_operators(torch, dev, mesh, lc, perm, dict(csr=cd, op=cd_op, perm=cd_perm))
    f32 = torch.float32
    out = {}
    for name, cls, csr in (("ic0/diffusion", IcPreconditioner, ops["diffusion"][2]),
                           ("sgs/ch", SgsPreconditioner, cs.sell_to_csr(step.operator)),
                           ("ilu0/convdiff", IluPreconditioner, ops["convdiff"][2])):
        pre = cls(csr, sweeps=cs.PRECOND_TRI_SWEEPS, dtype=f32, device=dev)
        out[f"{name}/lower"], out[f"{name}/upper"] = (pre._first, True), (pre._second, False)
    rp, cols, vals, (m, n) = cs.face_difference(mesh)
    iqr = IqrPreconditioner(CSR(data=vals, indices=cols.astype(np.int32),
                                row_ptr=rp.astype(np.int32), shape=(m, n)),
                            sweeps=cs.LSQ_SWEEPS, dtype=f32, device=dev)
    out["iqr/face_difference/upper"], out["iqr/face_difference/lower"] = ((iqr._r, False),
                                                                          (iqr._rt, True))
    return out


def build_old(torch, old: str, label: str) -> ctypes.CDLL:
    """The earlier ``tri_solve.cu`` named by ``old`` (a file, or a git
    revision of this checkout), built into build/t1_<label>/ and loaded
    with today's C entries' argument types."""
    from stormx_torch.ops import _cuda

    root = os.path.join(REPO, "build", f"t1_{label}")
    os.makedirs(root, exist_ok=True)
    src = os.path.join(root, "tri_solve.cu")
    if os.path.isfile(old):
        shutil.copyfile(old, src)
    else:
        text = subprocess.run(["git", "-C", REPO, "show", f"{old}:stormx_torch/csrc/tri_solve.cu"],
                              capture_output=True, text=True, check=True).stdout
        with open(src, "w") as f:
            f.write(text)
    lib_path = os.path.join(root, "libtri_solve.so")
    out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, src],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.stormx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.stormx_cuda_error_string.restype = ctypes.c_char_p
    for entry, argtypes in _cuda.ENTRIES["tri_solve"].items():
        if hasattr(lib, entry):  # an earlier source may lack a later probe
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@contextlib.contextmanager
def using(tk, lib):
    """T1's wrapper launching ``lib``'s kernels instead of today's."""
    from stormx_torch.ops import _cuda

    today = _cuda.library("tri_solve")
    _cuda._libs["tri_solve"] = lib
    tk._plans.clear()
    try:
        yield
    finally:
        _cuda._libs["tri_solve"] = today
        tk._plans.clear()


def case(torch, cs, tk, name, tri, flush, probes, *, plain: bool, seed: int = 0, olds=None):
    n, K, dtype = tri.num_rows, tri.ell_cols.shape[1], tri.ell_vals.dtype
    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = torch.randn(n, generator=gen, dtype=dtype).to(tri.ell_vals.device)
    runs = {"grid": lambda: tk.exact_cuda(tri, r)}
    for label, lib in (olds or {}).items():
        def run_old(lib=lib):
            with using(tk, lib):
                return tk.exact_cuda(tri, r)
        runs[f"grid_{label}"] = run_old
    y = {b: fn() for b, fn in runs.items()}
    torch.cuda.synchronize()
    tk.check_watchdog()
    strands = int(tri.strand_ptr.numel()) - 1
    rec = dict(case=name, rows=n, levels=tri.num_levels, K=K, dtype=str(dtype).split(".")[-1],
               mean_width=n / tri.num_levels,
               max_width=int(tri.level_rows.shape[1]), grid_slots=tk.grid_slots(K),
               grid_strands=strands)
    for label in olds or {}:
        rec[f"grid_equals_grid_{label}"] = bool(torch.equal(y["grid"], y[f"grid_{label}"]))
    if plain:
        rec["grid_equals_plain"] = bool(torch.equal(y["grid"], tk.exact_plain(tri, r)))
    reps = 30 if tri.num_levels < 20_000 else 7
    turns = ["grid"] + [f"grid_{label}" for label in olds or {}]
    for b in turns + turns[::-1]:  # in turns
        fn = runs[b]
        rec.setdefault(f"{b}_ms", []).append(cs.time_ms(torch, fn, reps=reps))
        rec.setdefault(f"{b}_ms_l2_flushed", []).append(cs.time_ms(torch, fn, flush=flush,
                                                                   reps=reps))
    tk.check_watchdog()
    for key in [k for k in rec if k.endswith("_ms") or k.endswith("_flushed")]:
        rec[key] = min(rec[key])
    rec["grid_hop_bound_ms"] = tri.num_levels * probes["l2_ns"] * 1e-6
    for b in turns:
        rec[f"{b}_ns_per_level"] = rec[f"{b}_ms"] * 1e6 / tri.num_levels
    return rec


def sweep_warps(torch, cs, tk, tri, per_sm, *, seed: int = 0):
    """"grid" on ``tri`` with its own strands (a warp each) and with the
    level order dealt out round robin to each number of warps an SM of
    ``per_sm`` (``round_robin_strands``: the same kernel and rows, few
    links): one record each, its warm CUDA-event median and its bits
    against the factor's own strands."""
    n = tri.num_rows
    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = torch.randn(n, generator=gen, dtype=tri.ell_vals.dtype).to(tri.ell_vals.device)
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    want = tk.exact_cuda(tri, r)
    out = []
    for w in [None] + list(per_sm):
        t = tri
        if w is not None:
            rows, ptr = tk.round_robin_strands(tri.order, max(1, min(round(w * sms), n)))
            t = tri._replace(strand_rows=rows, strand_ptr=ptr)
        warps = int(t.strand_ptr.numel()) - 1
        fn = lambda t=t: tk.exact_cuda(t, r)  # noqa: E731
        y = fn()
        torch.cuda.synchronize()
        tk.check_watchdog()
        ms = min(cs.time_ms(torch, fn, reps=30) for _ in range(2))
        out.append(dict(sweep="grid_warps_per_sm", strands="own" if w is None else "round_robin",
                        warps=warps, warps_per_sm=warps / sms, rows=n, levels=tri.num_levels,
                        grid_ms=ms, grid_ns_per_level=ms * 1e6 / tri.num_levels,
                        bit_equal=bool(torch.equal(y, want))))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="store_true", help="add the smoke's mesh factors")
    ap.add_argument("--sides", default="", help="add the same factors on the meshes of these "
                                                "grid sides (comma-separated)")
    ap.add_argument("--out", help="write the JSON lines here as well")
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)),
                    help="rows a level of the synthetic factors (comma-separated)")
    ap.add_argument("--dtypes", default="float32,float64", help="their dtypes")
    ap.add_argument("--slots", default="2,7", help="their K")
    ap.add_argument("--old", help="earlier csrc/tri_solve.cu sources (files or git revisions, "
                                  "comma-separated) to time beside \"grid\"")
    ap.add_argument("--sweep-warps", default="",
                    help="with --mesh: warps an SM to time \"grid\" at on the IC(0) factors, "
                         "the level order dealt out round robin (comma-separated)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_t1_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from stormx_torch.ops import _cuda
    from stormx_torch.ops import tri_solve as tk

    dev = torch.device("cuda", 0)
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    build_s = _cuda.build(["tri_solve"])
    ptxas = [ln for ln in _cuda.build_log.get("tri_solve", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    # The first --old is "old", the others "old2", "old3", ...
    olds = {f"old{i + 1 if i else ''}": build_old(torch, x, f"old{i + 1 if i else ''}")
            for i, x in enumerate(x for x in (args.old or "").split(",") if x)}
    flag_ns, flag_sms = tk.flag_hop_ns(dev)
    probes = dict(l2_ns=tk.l2_chase_ns(dev), flag_hop_ns=flag_ns, flag_hop_sms=flag_sms)
    emit(dict(card=cs.nvidia_smi(), build_s=build_s, ptxas=ptxas, **probes))
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    on_card = lambda tri: type(tri)(*(t.to(dev) for t in tri))  # noqa: E731
    t0 = time.perf_counter()
    emit(case(torch, cs, tk, "chain", on_card(chain(100_000, 1)).astype(torch.float32), flush,
              probes, plain=False, olds=olds))
    for dtype in [getattr(torch, d) for d in args.dtypes.split(",") if d]:
        for K in [int(k) for k in args.slots.split(",") if k]:
            for width in [int(w) for w in args.widths.split(",") if w]:
                levels = max(SYNTH_ROWS // width, 2)
                tri = on_card(synthetic(width, levels, K, seed=width + K)).astype(dtype)
                emit(case(torch, cs, tk, f"synthetic/w{width}", tri, flush, probes,
                          plain=levels <= 300, olds=olds))
                del tri
    sides = [int(x) for x in args.sides.split(",") if x] + ([cs.GRID_SIDE] if args.mesh else [])
    for side in sides:
        factors = mesh_factors(torch, dev, cs, side)
        for name, (tri, _) in factors.items():
            emit(dict(case(torch, cs, tk, name, tri, flush, probes, plain=True, olds=olds),
                      grid_side=side))
        if side == cs.GRID_SIDE and args.sweep_warps:
            per_sm = [float(x) for x in args.sweep_warps.split(",")]
            for name in ("ic0/diffusion/lower", "ic0/diffusion/upper"):
                for rec in sweep_warps(torch, cs, tk, factors[name][0], per_sm):
                    emit(dict(rec, case=name, grid_side=side))
    emit(dict(done=True, seconds=time.perf_counter() - t0, card=cs.nvidia_smi()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
