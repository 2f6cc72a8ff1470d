"""Check the port's spans against traced windows of a benchmark cell, and
measure what they cost while a profiler records.

    python3 scripts/torch_span_check.py --workload heat_ic0 --seed 2718281828 \
        [--pairs 2] [--device cuda:0] [--root .] [--out spans_heat_ic0.json]

In one process the cell is built and warmed as ``portbench/harness.py``
builds it; then traced windows (whole cycles past the harness's traced
seconds, each from the cycle numbered 0, so each does the same work) are
taken in turns with the program's span gate on and patched off (on, off,
off, on, ...).  A window with spans gives:

- the ``t1.launch`` and ``k1.launch`` spans against the T1 and K1 kernels of
  the reduced trace and the launch counters' deltas, and whether the n-th
  kernel starts after the n-th span;
- whether each ``precond.apply`` lies inside a benchmark ``precond`` span,
  to within 1 us;
- the card's idle time split by where the host was (``program_spans``), also
  on the device's clock as traced and aligned on the launch calls instead of
  the reads, and the per-layer metrics that read the spans.

Every window gives its host ms a Krylov iteration and each device
operation's start less its launch call's (never negative on one clock).
Prints one JSON object and writes it to ``--out``; ``--dump`` saves each
window's operations, launch calls and spans as an ``.npz``.
"""

import argparse
import bisect
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEW_METRICS = ("host.syncs_per_iter", "host.read_idle_us_per_iter",
               "host.dispatch_idle_us_per_iter", "device.idle_share",
               "host.launches_per_iter", "krylov.iterations")
CELL_METRICS = ("t1.host_us_per_call", "k1.host_us_per_call", "setup.operator_s",
                "setup.precond_factor_s", "precond.ms_per_apply")


QUANTILES = (0.0, 0.001, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0)


def quantiles_us(values_ns) -> dict:
    v = sorted(values_ns)
    if not v:
        return {}
    return {str(q): v[round(q * (len(v) - 1))] * 1e-3 for q in QUANTILES}


def kernel_check(run, kernels, spans, kid: str, span_name: str, counted: int) -> dict:
    """The n-th kernel ``kid`` against the n-th span ``span_name``: counts, and
    the kernel's start less the span's, on the device's clock as traced and
    moved onto the host's by ``program_spans.host_offsets``."""
    from portbench import program_spans

    pattern = re.compile(kernels[kid].PATTERN)
    ops = sorted((op for op in run.trace.ops if pattern.search(op.name)),
                 key=lambda op: op.start_ns)
    calls = sorted((s for s in spans if s.name == span_name), key=lambda s: s.start_ns)
    out = {"spans": len(calls), "kernels": len(ops), "counted": counted}
    anchors = program_spans.host_offsets(run, spans)
    for clock in ("traced", "moved"):
        leads = []
        for s, op in zip(calls, ops):
            t = op.start_ns
            if clock == "moved" and anchors:
                copies, offsets = anchors
                t += offsets[min(bisect.bisect_left(copies, t), len(copies) - 1)]
            leads.append(t - s.start_ns)
        out[clock] = {"kernel_after_span": bool(leads) and min(leads) > 0,
                      "negative_leads": sum(1 for x in leads if x < 0),
                      "lead_us": quantiles_us(leads)}
    return out


def launch_calls(events) -> dict:
    """Correlation id -> host start of the CUDA runtime call (as
    ``portbench/trace.py`` takes them)."""
    import torch

    dt = torch.autograd.DeviceType
    return {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() == dt.CPU and e.name().startswith(("cuda", "cu"))
            and not e.name().startswith("cudnn")}


def device_events(events):
    import torch

    dt = torch.autograd.DeviceType
    return [e for e in events if e.device_type() == dt.CUDA and not e.is_user_annotation()]


def launch_offsets(events) -> tuple[list, list]:
    """Host clock less device clock along the window, from the launch calls:
    at each device operation's start (sorted), 3 us (a launch's least
    latency) less the least (start − its launch call's start) of the
    operations launched within 1 ms of it."""
    calls = launch_calls(events)
    pairs = sorted((calls[e.correlation_id()], e.start_ns()) for e in device_events(events)
                   if e.correlation_id() in calls)
    launched = [p[0] for p in pairs]
    lags = [d - h for h, d in pairs]
    offsets = []
    for h in launched:
        lo, hi = bisect.bisect_left(launched, h - 10**6), bisect.bisect_right(launched, h + 10**6)
        offsets.append(3000 - min(lags[lo:hi]))
    by_start = sorted(zip((d for _, d in pairs), offsets))
    return [t for t, _ in by_start], [o for _, o in by_start]


def clock_check(events, kernels, spans) -> dict:
    """The device's timeline against the host's: each device operation's
    start less the start of the CUDA runtime call that launched it (never
    negative on one clock), by kind; and each blocking read's end less the
    end of the last device operation that ended before it."""
    calls = launch_calls(events)
    lags: dict = {}
    ends = []
    patterns = {kid: re.compile(mod.PATTERN) for kid, mod in kernels.items()}
    for e in device_events(events):
        ends.append(e.end_ns())
        t = calls.get(e.correlation_id())
        if t is None:
            continue
        kind = next((k for k, p in patterns.items() if p.search(e.name())),
                    "memcpy" if "Memcpy" in e.name() else "other")
        lags.setdefault(kind, []).append(e.start_ns() - t)
    ends.sort()
    after = []
    for s in spans:
        if s.name == "solver.read":
            k = bisect.bisect_right(ends, s.end_ns) - 1
            if k >= 0:
                after.append(s.end_ns - ends[k])
    return {"launch_lag_us": {k: quantiles_us(v) for k, v in lags.items()},
            "negative_lags": {k: sum(1 for x in v if x < 0) for k, v in lags.items()},
            "read_end_after_device_us": quantiles_us(after)}


def contained(inner, outer, slack_ns: int) -> dict:
    """Each ``inner`` span against the benchmark intervals ``outer``."""
    worst = 0
    for s in inner:
        k = bisect.bisect_right(outer, (s.start_ns + slack_ns, float("inf"))) - 1
        if k < 0:
            worst = max(worst, 10**12)
            continue
        lo, hi = outer[k]
        worst = max(worst, lo - s.start_ns, s.end_ns - hi)
    return {"spans": len(inner), "benchmark_spans": len(outer),
            "worst_excess_ns": worst, "inside": worst <= slack_ns}


def raw_arrays(events, spans) -> dict:
    """Each device operation's (start, end, its launch call's host start or
    -1); each program span's (id, start, end, parent or -1) and names."""
    import numpy as np

    calls = launch_calls(events)
    ops, names = [], []
    for e in device_events(events):
        ops.append((e.start_ns(), e.end_ns(), calls.get(e.correlation_id(), -1)))
        names.append(e.name()[:40])
    span_names = sorted({s.name for s in spans})
    return {"ops": np.array(ops, dtype=np.int64).reshape(-1, 3),
            "op_names": np.array(names),
            "spans": np.array([(s.id, s.start_ns, s.end_ns, -1 if s.parent is None else s.parent,
                                span_names.index(s.name)) for s in spans],
                              dtype=np.int64).reshape(-1, 5),
            "span_names": np.array(span_names)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--root", default=ROOT, help="the checkout whose benchmark to run")
    p.add_argument("--seconds", type=float, default=None,
                   help="a window's seconds (default: the harness's traced seconds)")
    p.add_argument("--out", default=None)
    p.add_argument("--dump", default=None,
                   help="an .npz of each window's device operations, launch calls and spans")
    args = p.parse_args(argv)

    root = os.path.abspath(args.root)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    sys.path.insert(0, ROOT)
    if root != ROOT:
        sys.path.insert(0, root)

    from portbench import harness, program_spans
    from portbench import trace as tracing
    from stormx_torch.core import profiling

    t0 = time.perf_counter()
    bench = harness.Bench(root)
    cell = harness.Cell(bench, args.workload, args.device)
    system = cell.program()
    system.load(cell.inputs(args.seed))
    item_bytes = harness.warm(system)
    system.traced = True
    tracing.profile(lambda: harness.warm(system), cell.device)  # the first session loses records
    harness.synchronize(cell.device)
    kernels = bench.kernels()
    seconds = args.seconds or harness.TRACE_SECONDS
    suffix = "." + cell.traffic["unit_metric"].split("_")[0]
    gate = profiling.recording
    out = {"workload": args.workload, "seed": args.seed, "device": str(cell.device),
           "card": harness.power_limit(), "setup_s": time.perf_counter() - t0, "windows": []}

    dumps: dict = {}
    order = ["on", "off", "off", "on"] * (args.pairs // 2) + ["on", "off"] * (args.pairs % 2)
    for state in order:
        profiling.recording = gate if state == "on" else (lambda: False)
        keeper = harness.Keeper(args.seed, item_bytes)
        before = system.counters()
        (records, window_s), events = tracing.profile(
            lambda: harness.measure(system, seconds, keeper), cell.device)
        after = system.counters()
        profiling.recording = gate
        reduced = tracing.reduce(events)
        run = harness.Run(workload=args.workload, records=records, window_s=window_s,
                          info=system.info, setup_times=system.setup_times, trace=reduced,
                          kernels=kernels)
        w = {"spans": state, "window_s": window_s, "iterations": run.iterations,
             "ms_per_iter": 1e3 * window_s / run.iterations,
             "lost": {k: list(v) for k, v in
                      harness.lost_records(reduced, kernels, before, after).items()},
             "busy_s": reduced.busy_s(), "trace_window_s": reduced.window_s}
        spans = program_spans.in_window(run) or []
        w["program_spans"] = len(spans)
        w["clock"] = clock_check(events, kernels, spans)
        if args.dump:
            import numpy as np

            arrays = raw_arrays(events, spans)
            for name, iv in reduced.spans.items():
                arrays["bench_" + name] = np.array(iv, dtype=np.int64).reshape(-1, 2)
            arrays["window"] = np.array(reduced.window, dtype=np.int64)
            dumps[f"w{len(out['windows'])}"] = arrays
        if state == "on" and spans:
            counted = {k: after[k] - before.get(k, 0) for k in after}
            w["t1"] = kernel_check(run, kernels, spans, "t1", "t1.launch", counted["t1"])
            w["k1"] = kernel_check(run, kernels, spans, "k1", "k1.launch", counted["k1"])
            w["precond_apply_in_precond"] = contained(
                [s for s in spans if s.name == "precond.apply"],
                reduced.spans.get("precond", []), 1000)
            split = program_spans.idle_split(run)
            if split is not None:  # None without device operations (the CPU)
                idle_ns = reduced.window_s * 1e9 - reduced.busy_s() * 1e9
                w["idle_split_s"] = {k: v * 1e-9 for k, v in split.items()}
                w["idle_s"] = idle_ns * 1e-9
                w["split_sum_over_idle"] = sum(split.values()) / idle_ns
                idle, by_id = program_spans.idle_by_span(run)
                names: dict = {}
                for sid, ns in idle.items():
                    key = "outside" if sid is None else by_id[sid].name
                    names[key] = names.get(key, 0) + ns * 1e-9
                w["idle_by_innermost_s"] = dict(sorted(names.items(), key=lambda kv: -kv[1]))
                # the same split on the device's clock as traced, and moved
                # onto the host's by the launch calls instead of the reads
                anchored = program_spans.host_offsets
                for label, offsets in (("traced", None), ("launch", launch_offsets(events))):
                    program_spans.host_offsets = lambda run, spans, o=offsets: o
                    other = program_spans.idle_split(run)
                    w[f"idle_split_s_{label}"] = {k: v * 1e-9 for k, v in other.items()}
                program_spans.host_offsets = anchored
            metrics = {}
            for name in [m + suffix for m in NEW_METRICS] + list(CELL_METRICS):
                value = bench.reader(name).read(run)
                if value is not None:
                    metrics[name] = value
            w["metrics"] = metrics
        out["windows"].append(w)
        print(json.dumps(w), file=sys.stderr, flush=True)

    for state in ("on", "off"):
        ms = [w["ms_per_iter"] for w in out["windows"] if w["spans"] == state]
        out[f"ms_per_iter_{state}"] = ms
    on, off = out["ms_per_iter_on"], out["ms_per_iter_off"]
    out["on_cost"] = sum(on) / len(on) / (sum(off) / len(off)) - 1.0
    system.free()
    if args.dump:
        import numpy as np

        flat = {f"{w}_{k}": v for w, arrays in dumps.items() for k, v in arrays.items()}
        np.savez_compressed(args.dump, **flat)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
