"""Whole runs of small cells on the CPU (the harness's look for a card
skipped): the last line's shape, cells and metrics added as new files only,
the control and the faults coming out not correct, lost trace records
failing the run, and ``run.py``'s refusals."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import REPO, file_hashes

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, trace=False, seed=2**33 + 7, seconds=0.2, **kw):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            bench=harness.Bench(root), **kw)


@pytest.mark.parametrize("cell", ["tiny_heat", "tiny_cg"])
def test_last_line(tiny_root, cell):
    result, compared = run(tiny_root, cell)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    unit = "step_ms" if cell == "tiny_heat" else "solve_ms"
    assert set(result["metrics"]) == {unit, "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert {n for n, _, _ in compared} == set(result["checks"]) >= {"unconverged"}
    json.loads(json.dumps(result))


@pytest.mark.parametrize("cell", ["tiny_heat", "tiny_cg"])
def test_traced_line(tiny_root, cell):
    result, _ = run(tiny_root, cell, trace=True)
    assert list(result)[-2:] == ["breakdown", "checks"]
    assert result["correct"] is True
    suffix = ".step" if cell == "tiny_heat" else ".solve"
    assert "krylov.iterations" + suffix in result["metrics"]
    assert not {"step_ms", "solve_ms", "setup_s"} & set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_cell_and_metric_added_as_new_files(tiny_root):
    """A new metric is a new reader file and an entry in BENCHMARK.json; the
    small cells are new files too.  No file that was there changes."""
    before = file_hashes(REPO)
    with open(os.path.join(tiny_root, "portbench", "metrics", "krylov.twice.py"), "w") as f:
        f.write("def read(run):\n    return 2.0 * run.iterations / len(run.records)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "krylov.twice", "unit": "count", "better": "lower",
                              "source": "program_counter", "layer": spec["per_layer"][0]["layer"],
                              "moves": "solve_ms", "workloads": ["tiny_cg"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    result, _ = run(tiny_root, "tiny_cg", trace=True)
    m = result["metrics"]
    assert m["krylov.twice"]["value"] == pytest.approx(2 * m["krylov.iterations.solve"]["value"])
    assert file_hashes(REPO) == before
    copied = file_hashes(tiny_root)
    assert all(copied[k] == v for k, v in before.items() if k != "BENCHMARK.json")


@pytest.mark.parametrize("cell", ["tiny_heat", "tiny_cg"])
def test_the_control_is_not_correct(tiny_root, cell):
    """The reference in the program's place, one precision below the
    configuration's (bfloat16 for float32, float32 for float64)."""
    result, compared = run(tiny_root, cell, make_system=lambda c: c.control())
    assert result["correct"] is False, compared


def unchanged(c):
    """A step that returns its state unchanged (a solve: its start, x0 = 0),
    and hands that state on."""
    system = c.program()
    inner = system.solve_next

    def solve_next():
        key, answer, it, ok = inner()
        start = answer[0] if len(answer) == 2 else torch.zeros_like(answer[0])
        if len(answer) == 2:
            system.u = start
        return key, answer[:-1] + (start,), it, ok
    system.solve_next = solve_next
    return system


def altered(c):
    """An answer altered where it is produced."""
    system = c.program()
    inner = system.solve_next

    def solve_next():
        key, answer, it, ok = inner()
        x = answer[-1].clone()
        x[0] += x.abs().max()
        return key, answer[:-1] + (x,), it, ok
    system.solve_next = solve_next
    return system


@pytest.mark.parametrize("fault", [unchanged, altered])
@pytest.mark.parametrize("cell", ["tiny_heat", "tiny_cg"])
def test_a_fault_is_not_correct(tiny_root, cell, fault):
    result, compared = run(tiny_root, cell, make_system=fault)
    assert result["correct"] is False, compared


def test_lost_records_fail_the_traced_run(tiny_root):
    """The port's launch counters claim a T1 launch the trace never saw."""
    def claiming(c):
        system = c.program()
        counts = iter(range(10**6))
        system.counters = lambda: {"t1": next(counts)}
        return system
    with pytest.raises(harness.RunError, match="lost kernel records"):
        run(tiny_root, "tiny_heat", trace=True, make_system=claiming)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"),
                        "--workload", "dia_cg", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    from portbench.tests.tiny import add_tiny_cells, copy_bench

    root = add_tiny_cells(copy_bench(str(tmp_path / "bare"), with_program=False))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench import harness; "
            "print(harness.run_cell('tiny_cg', 1, 0.1, False, device='cpu', "
            "bench=harness.Bench(sys.argv[1])))")
    p = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True,
                       timeout=300, cwd=root)
    assert p.returncode != 0 and "correct" not in p.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"),
                        "--workload", "dia_cg", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=900, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
