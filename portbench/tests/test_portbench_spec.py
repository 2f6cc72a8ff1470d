"""BENCHMARK.json keeps to the rules of its format, and everything of one cell,
configuration or metric is a file of its own that the harness finds by
name."""

import json
import math
import os
import re

import pytest

from portbench import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and 1 <= len(spec["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
               for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    cells = 24  # the most a later PR may grow the benchmark to
    assert (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_text(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in spec[k]}) == len(spec[k])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for x in spec["configs"] + spec["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


def test_configs(spec):
    used = {w["config"] for w in spec["workloads"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["source"].startswith("https://")
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_cells(spec):
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert 1 <= len(spec["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        e2e = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert bench_traffic(w)["unit_metric"] in names
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in spec["per_layer"])


def bench_traffic(cell):
    return harness.Bench(REPO).traffic(cell["traffic"])


def test_bounds_and_moves(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        # each cell that lists the metric reports the metric it moves
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(m["workloads"]) <= set(moved)
        assert 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split("_roofline")[0].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items() if k not in ("setup",))


def test_found_by_name(spec):
    """Every cell's configuration, traffic, limits, system and reference,
    and every metric's reader, is a file the harness finds by its name."""
    bench = harness.Bench(REPO)
    for w in spec["workloads"]:
        cfg = bench.config(w["config"])
        assert bench.traffic(w["traffic"])["name"] == w["traffic"]
        assert set(bench.limits(w["name"])) >= {"unconverged"}
        assert hasattr(bench.system(cfg), "System")
        ref = bench.reference(cfg)
        assert hasattr(ref, "check") and hasattr(ref, "Control")
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    for kid, mod in bench.kernels().items():
        assert re.compile(mod.PATTERN) and mod.SPAN in ("operator", "precond")


def test_limits_are_set(spec):
    """Each cell's limits are numbers, the exact count's at 0."""
    for w in spec["workloads"]:
        lim = harness.Bench(REPO).limits(w["name"])
        assert lim["unconverged"] == 0
        assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
                   for v in lim.values())
