"""A copy of the benchmark with small cells added as new files only, for the
CPU tests: ``tiny_heat`` (a 14 × 14 grid's mesh) and ``tiny_cg`` (a
48 × 48 grid), each with the limits of the cell it shrinks."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# new cell -> (the cell it shrinks, the new configuration, its changed keys,
# the traffic where it is not the shrunk cell's)
TINY = {
    "tiny_heat": ("heat_ic0", "tiny_heat318", {"grid_side": 14}, None),
    "tiny_cg": ("dia_cg", "tiny_poisson", {"nx": 48}, None),
}


def file_hashes(root: str) -> dict:
    import hashlib

    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    with open(os.path.join(root, "BENCHMARK.json"), "rb") as fh:
        out["BENCHMARK.json"] = hashlib.sha256(fh.read()).hexdigest()
    return out


def copy_bench(dst: str, with_program: bool = True) -> str:
    """The committed benchmark (BENCHMARK.json and portbench/) under
    ``dst``, with the program beside it as a link when asked."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        os.symlink(os.path.join(REPO, "stormx_torch"), os.path.join(dst, "stormx_torch"))
    return dst


def add_tiny_cells(root: str) -> str:
    """Add the small cells to the copy at ``root`` as new files, plus their
    entries in BENCHMARK.json and in the workloads of every metric that
    lists the cell they shrink."""
    pb = os.path.join(root, "portbench")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for name, (big, cfg_name, changes, traffic) in TINY.items():
        big_cell = cells[big]
        if cfg_name not in {c["name"] for c in spec["configs"]}:
            src = configs[big_cell["config"]]
            with open(os.path.join(root, src["file"])) as f:
                cfg = json.load(f)
            cfg.update(changes, name=cfg_name)
            rel = f"portbench/configs/{cfg_name}.json"
            with open(os.path.join(root, rel), "w") as f:
                json.dump(cfg, f)
            spec["configs"].append(dict(src, name=cfg_name, file=rel,
                                        reduced=src["reduced"] + sorted(changes)))
        spec["workloads"].append(dict(big_cell, name=name, config=cfg_name,
                                      traffic=traffic or big_cell["traffic"]))
        shutil.copy(os.path.join(pb, "limits", f"{big}.json"),
                    os.path.join(pb, "limits", f"{name}.json"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if big in m.get("workloads", []):
                m["workloads"].append(name)
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)
    return root
