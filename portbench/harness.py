"""The benchmark of ``stormx_torch``: one run of one cell.

Everything of one configuration, traffic mix or per-layer metric is a file
of its own, found by name:

- ``BENCHMARK.json`` (the checkout's root) names the cells, configurations
  and metrics;
- ``configs/<name>.json``: a configuration, whose ``system`` names
  ``systems/<system>.py`` (the port, built as its users build it) and
  ``reference/<system>.py`` (the plain reference and the control);
- ``traffic/<name>.json``: a traffic mix, the parameters that
  ``inputs/draws.py`` and the system read (each cycle of a run draws its
  inputs afresh, from the seed and the cycle's number);
- ``limits/<cell>.json``: the limit of each number that ``correct``
  compares;
- ``metrics/<name>.py``: a per-layer metric's reader, ``read(run)``;
- ``kernels/<id>.py``: a kernel's name pattern and byte count.

A run builds the cell, warms it with one short unit of a few iterations
(every kernel and shape of the timed units), measures whole cycles
of the traffic until ``seconds`` have passed (with ``trace``, under the
profiler, until :data:`TRACE_SECONDS` have), reads the device's peak
memory, frees the program and holds the sampled answers to the reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import re
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench import trace as tracing

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
TRACE_SECONDS = 5.0  # the traced window: whole cycles until this has passed
TRACE_ATTEMPTS = 3  # traced windows taken before lost records fail the run
KEEP_BYTES = 2**29  # the answers kept for the check, drawn from the seed
WARM_ITERATIONS = 3  # iterations of the warm-up unit
FORBIDDEN = ("jax", "jaxlib", "flax", "stormx")  # top-level module names
# The control's dtype: the nearest precision below the configuration's.
BELOW = {"float64": torch.float32, "float32": torch.bfloat16}


class RunError(RuntimeError):
    """A run that must end without a result."""


@dataclass
class Run:
    """What a per-layer metric reads."""

    workload: str
    records: list  # ((cycle, slot), iterations, converged) of every timed unit
    window_s: float
    info: dict
    setup_times: dict
    trace: tracing.Trace | None = None
    peaks: dict | None = None
    kernels: dict = field(default_factory=dict)

    @property
    def iterations(self) -> int:
        return sum(r[1] for r in self.records)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark's files under one checkout root."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.pkg = os.path.join(root, "portbench")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise RunError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise RunError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.pkg, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.pkg, "limits", f"{cell}.json"))

    def system(self, config: dict):
        return load_module(os.path.join(self.pkg, "systems", f"{config['system']}.py"),
                           f"portbench_system_{config['system']}")

    def reference(self, config: dict):
        return load_module(os.path.join(self.pkg, "reference", f"{config['system']}.py"),
                           f"portbench_reference_{config['system']}")

    def kernels(self) -> dict:
        d = os.path.join(self.pkg, "kernels")
        return {f[:-3]: load_module(os.path.join(d, f), f"portbench_kernel_{f[:-3]}")
                for f in sorted(os.listdir(d)) if f.endswith(".py") and f != "__init__.py"}

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        return load_module(os.path.join(self.pkg, "metrics", f"{name}.py"),
                           "portbench_metric_" + name.replace(".", "_"))

    def peaks(self, kind: str) -> dict | None:
        return load_json(os.path.join(self.pkg, "peaks.json")).get(kind)


def process_age() -> float | None:
    """Seconds since this process started, from /proc; None where unread."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None
    return age if 0.0 <= age < 86400.0 else None


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> list[str]:
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


class Keeper:
    """A sample of the window's answers, drawn from the seed (reservoir
    sampling), of at most ``KEEP_BYTES``; each copied on the device."""

    def __init__(self, seed: int, item_bytes: int):
        self.cap = max(1, KEEP_BYTES // max(item_bytes, 1))
        self.rng = random.Random(seed)
        self.kept: list = []
        self.seen = 0

    def offer(self, key, answer: tuple) -> None:
        self.seen += 1
        if len(self.kept) < self.cap:
            self.kept.append((key, tuple(t.clone() for t in answer)))
            return
        k = self.rng.randrange(self.seen)
        if k < self.cap:
            self.kept[k] = (key, tuple(t.clone() for t in answer))


def measure(system, seconds: float, keeper: Keeper, cycles: list | None = None
            ) -> tuple[list, float]:
    """Whole cycles, numbered from 0, until ``seconds`` have passed; each
    unit ends in a synchronise.  Returns the records and the window's
    seconds; appends each cycle's (seconds, iterations) to ``cycles``."""
    records = []
    t0 = time.perf_counter()
    cycle = 0
    while True:
        t_cycle = time.perf_counter()
        system.begin_cycle(cycle)
        iterations = 0
        for _ in range(system.cycle_len):
            key, answer, n, converged = system.solve_next()
            records.append((key, n, converged))
            keeper.offer(key, answer)
            iterations += n
        if cycles is not None:
            cycles.append((time.perf_counter() - t_cycle, iterations))
        cycle += 1
        if time.perf_counter() - t0 >= seconds:
            return records, time.perf_counter() - t0


class Cell:
    """One cell's files and modules, and its fixed inputs (mesh, grid)."""

    def __init__(self, bench: Bench, workload: str, device):
        self.bench, self.workload = bench, workload
        self.spec = bench.cell(workload)
        self.config = bench.config(self.spec["config"])
        self.traffic = bench.traffic(self.spec["traffic"])
        self.limits = bench.limits(workload)
        self.sysmod = bench.system(self.config)
        self.refmod = bench.reference(self.config)
        self.device = torch.device(device)
        self.fixed = self.sysmod.make_fixed(self.config)

    def inputs(self, seed: int):
        """The function that gives cycle ``cycle``'s inputs of the run of
        ``seed``, the same to the program and to the reference."""
        def of_cycle(cycle: int) -> dict:
            return self.sysmod.make_inputs(self.fixed, self.config, self.traffic, seed, cycle,
                                           self.device)
        return of_cycle

    def program(self):
        return self.sysmod.System(self.fixed, self.config, self.traffic, self.device)

    def control(self, dtype=None):
        """The reference in the program's place, in ``dtype`` (by default
        the nearest precision below the configuration's)."""
        dtype = dtype or BELOW[self.config["dtype"]]
        return self.refmod.Control(self.fixed, self.config, self.traffic, self.device, dtype)

    def judge(self, inputs, records: list, samples: list) -> tuple[list, bool]:
        """The compared numbers as (name, value, limit), and ``correct``:
        every unit converged and the reference holds the sampled answers."""
        numbers = {"unconverged": sum(1 for r in records if not r[2])}
        numbers.update(self.refmod.check(self.fixed, inputs, samples, self.config,
                                         self.traffic, self.device))
        compared = []
        for name, value in numbers.items():
            if name not in self.limits:
                raise RunError(f"no limit for {name!r} in limits/{self.workload}.json")
            compared.append((name, value, self.limits[name]))
        return compared, bool(records) and all(v <= lim for _, v, lim in compared)


def warm(system) -> int:
    """One unit of a cycle that is not timed (numbered −1), cut to
    :data:`WARM_ITERATIONS`: every kernel and shape of the cell's traffic.
    Returns the bytes of its answer."""
    system.begin_cycle(-1)
    cap, system.max_iterations = system.max_iterations, WARM_ITERATIONS
    try:
        _, answer, _, _ = system.solve_next()
    finally:
        system.max_iterations = cap
    synchronize(answer[0].device)
    return sum(t.numel() * t.element_size() for t in answer)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device,
             bench: Bench | None = None, age=None, make_system=None) -> tuple[dict, list]:
    """One run of one cell on ``device``.  Returns (the result line, the
    compared numbers as (name, value, limit)).  ``age()`` gives the seconds
    since the process started (by default, since this call);
    ``make_system(cell)`` puts another system in the program's place (the
    control, a fault)."""
    if age is None:
        t_call = time.perf_counter()
        age = lambda: time.perf_counter() - t_call  # noqa: E731
    bench = bench or Bench()
    cell = Cell(bench, workload, device)
    device = cell.device
    inputs = cell.inputs(seed)
    system = cell.program() if make_system is None else make_system(cell)
    system.load(inputs)
    item_bytes = warm(system)
    if trace:
        # A first profiler run loses records (PERF.md): take one over a
        # second warm-up unit, and discard it.
        system.traced = True
        tracing.profile(lambda: warm(system), device)
    synchronize(device)
    setup_s = age()

    keeper = Keeper(seed, item_bytes)
    reduced = None
    cycles: list = []
    if not trace:
        records, window_s = measure(system, seconds, keeper, cycles)
    else:
        kernels = bench.kernels()
        for attempt in range(TRACE_ATTEMPTS):
            before = system.counters()
            (records, window_s), events = tracing.profile(
                lambda: measure(system, min(seconds, TRACE_SECONDS), keeper), device)
            after = system.counters()
            reduced = tracing.reduce(events)
            lost = lost_records(reduced, kernels, before, after)
            if not lost:
                break
            print(f"portbench: traced window {attempt + 1} lost records: {lost}",
                  file=sys.stderr)
        else:
            raise RunError(f"the profiler lost kernel records in {TRACE_ATTEMPTS} "
                           f"traced windows: {lost}")

    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    run = Run(workload=workload, records=records,
              window_s=window_s, info=system.info, setup_times=system.setup_times,
              trace=reduced)
    samples = [(key, tuple(system.to_input(t) for t in answer)) for key, answer in keeper.kept]
    keeper.kept.clear()
    system.free()
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: {found}")

    compared, correct = cell.judge(inputs, records, samples)
    if cycles:
        print("portbench: cycles (s, iterations): "
              + json.dumps(cycles), file=sys.stderr)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.spec["chips"], "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    metrics = {}
    if not trace:
        # The traffic names the metric of its timed unit (a solve, a step).
        values = {cell.traffic["unit_metric"]: 1e3 * window_s / len(records), "setup_s": setup_s}
        for m in bench.metrics("end_to_end", workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run.peaks = bench.peaks(kind)
        run.kernels = kernels
        dev["busy_s"] = reduced.busy_s()
        dev["window_s"] = reduced.window_s
        for m in bench.metrics("per_layer", workload):
            value = bench.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(records),
              "failed": sum(1 for r in records if not r[2]), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": [list(r) for r in reduced.device_ops()],
                               "idle_gaps": [list(r) for r in reduced.idle_gaps()]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return result, compared


def lost_records(reduced: tracing.Trace, kernels: dict, before: dict, after: dict) -> dict:
    """Kernels whose count in the trace differs from the port's launch
    counters over the same window: {kernel id: (traced, counted)}."""
    lost = {}
    for kid, counted in after.items():
        mod = kernels.get(kid)
        if mod is None:
            continue
        pattern = re.compile(mod.PATTERN)
        traced = sum(1 for op in reduced.ops if pattern.search(op.name))
        if traced != counted - before.get(kid, 0):
            lost[kid] = (traced, counted - before.get(kid, 0))
    return lost
