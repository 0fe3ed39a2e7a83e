"""One run of one benchmark cell: set-up, the measured window, the traced
ticks with --trace 1, the check against the plain reference, and the
result line.

Everything particular to a cell is data found by name: the cell in
BENCHMARK.json, its configuration (``configs/<config>.json``), its mix
(``traffic/<traffic>.json``, whose "generator" and "driver" keys name the
generator's kind and ``drivers/<driver>.py``), its limits
(``limits/<workload>.json``), each per-layer metric's reader
(``metrics/<name>.py``) and each kernel's work (``rooflines/<k>.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

from . import check, trace
from .peaks import least_seconds

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orcvio_tpu")


class Run:
    """What a run gathered, as the metric readers see it."""

    def __init__(self, rows: int):
        self.rows = rows
        self.ticks = 0
        self.issue_s = 0.0
        self.tick_ends = []
        self.collected = {}
        self.trace = None  # the CUDA-only profile's summary
        self.kernels = {}  # roofline name -> {"device_s", "least_s"}


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json",
              data: Path = HERE):
    """(the cell, its configuration, its mix, the per-layer metrics it
    reports, the end-to-end metrics it reports, its limits) from
    BENCHMARK.json and the files under data (traffic/, limits/)."""
    spec = json.loads(Path(bench_path).read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"vio_bench: no workload named {workload!r}")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((data / "traffic" / f"{cell['traffic']}.json").read_text())
    lims = json.loads((data / "limits" / f"{workload}.json").read_text())

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return (cell, cfg, mix, mine(spec["per_layer"]), mine(spec["end_to_end"]),
            lims["limits"])


def process_start() -> float:
    """The process's start on the time.perf_counter() clock: its age from
    /proc (the seconds since boot less its start tick, to 10 ms), taken
    off the clock now; now itself where /proc cannot tell."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def window(driver, seconds: float, run: Run) -> float:
    """Calls of the entry, one tick each, until `seconds` have passed on
    the host clock, then a synchronisation: the window's length. No host
    read inside; each tick's end is marked by a CUDA event."""
    ev = torch.cuda.Event
    cuda = torch.device(driver.device).type == "cuda"
    driver.collecting = True
    driver.collected = {k: [] for k in driver.collected}
    if cuda:
        torch.cuda.synchronize()
        start = ev(enable_timing=True)
        start.record()
        run.tick_ends = [start]
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        driver.tick()
        run.issue_s += time.perf_counter() - a
        run.ticks += 1
        if cuda:
            e = ev(enable_timing=True)
            e.record()
            run.tick_ends.append(e)
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    length = time.perf_counter() - t0
    driver.collecting = False
    run.collected = driver.collected
    return length


def step_ms(run: Run) -> list:
    """Milliseconds between consecutive tick ends, by the CUDA events."""
    e = run.tick_ends
    return [a.elapsed_time(b) for a, b in zip(e, e[1:])]


def traced(driver, run: Run, mix: dict, kernel_names: list) -> dict:
    """The traced ticks after the window: CUDA activity alone over
    mix["trace_ticks"] ticks (busy and idle, launches, device ops), then
    the host too over mix["host_trace_ticks"] ticks with a profiler range
    around each roofline's op entry (kernel seconds against least
    seconds, and the idle gaps by the host op under way)."""
    n = mix["trace_ticks"]
    prof, window_s = trace.profile_ticks(driver.tick, n, host=False)
    events = trace.device_events(prof)
    busy_s, _ = trace.union((a, b) for _, a, b, *_ in events)
    run.trace = {"ticks": n, "window_s": window_s, "busy_s": busy_s,
                 "kernels": sum(1 for *_, k in events if k),
                 "device_ops": trace.by_name(events)[:10]}
    del prof, events
    ranges = trace.Ranges()
    mods = {name: importlib.import_module(f"vio_bench.rooflines.{name}")
            for name in kernel_names}
    stack = []
    for name, mod in mods.items():
        cm = ranges.around(name, importlib.import_module(mod.ENTRY[0]),
                           mod.ENTRY[1])
        cm.__enter__()
        stack.append(cm)
    try:
        prof, _ = trace.profile_ticks(driver.tick, mix["host_trace_ticks"],
                                      host=True)
    finally:
        for cm in reversed(stack):
            cm.__exit__(None, None, None)
    dev_s = trace.range_kernel_seconds(prof)
    _, merged = trace.union((a, b) for _, a, b, *_ in trace.device_events(prof))
    gaps = trace.idle_gaps(prof, merged)
    del prof
    for name, mod in mods.items():
        least = 0.0
        for args, batched, kwargs, rows in ranges.calls.get(name, []):
            least += least_seconds(*mod.count(args, batched, kwargs, rows))
        run.kernels[name] = {"device_s": dev_s.get(name, 0.0),
                             "least_s": least,
                             "calls": len(ranges.calls.get(name, []))}
    run.trace["launch_matched"] = dev_s[None]
    return {"device_ops": run.trace["device_ops"], "idle_gaps": gaps}


def reader(name: str):
    """The reader module of metric `name`, ``metrics/<name>.py`` (loaded
    by path: a metric's name may hold a dot)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vio_bench.metrics.{name.replace('.', '_')}", path,
        submodule_search_locations=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "vio_bench.metrics"
    spec.loader.exec_module(mod)
    return mod


def read_metrics(names, run: Run) -> dict:
    out = {}
    for m in names:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None, device=None, bench_path=ROOT / "BENCHMARK.json",
         data=HERE) -> int:
    """Run one cell; print the result line. device: the card unless
    given (the tests pass "cpu", and their own cells, to drive a run
    without one)."""
    import argparse

    t_start = process_start()
    ap = argparse.ArgumentParser(prog="vio_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, mix, per_layer, e2e, lims = load_cell(args.workload,
                                                     bench_path, data)
    if device is None:
        if not torch.cuda.is_available():
            print("vio_bench: CUDA is not available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"vio_bench: {cell['chips']} devices wanted, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
    cuda = torch.device(device).type == "cuda"
    driver_mod = importlib.import_module(f"vio_bench.drivers.{mix['driver']}")
    driver = driver_mod.Driver(cfg, mix, args.seed, device)
    for _ in range(mix["warm_ticks"]):
        driver.tick()
    driver.restart()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    run = Run(driver.rows)
    driver.arm(args.seed)
    window_s = window(driver, args.seconds, run)
    while driver.sampler.pending():  # a sampled tick past a short window
        driver.tick()
    breakdown = None
    if args.trace:
        kernels = sorted({m["name"].split("_roofline")[0] for m in per_layer
                          if m["name"].endswith("_roofline")})
        breakdown = traced(driver, run, mix, kernels) if cuda else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.window_s, run.setup_s = window_s, setup_s
    run.step_ms = step_ms(run) if cuda else []
    metrics = read_metrics(per_layer if args.trace else e2e, run)
    attempted = run.ticks * driver.rows
    p = torch.cat([x.reshape(-1, 3) for x in run.collected["p"]])
    failed = int((~torch.isfinite(p).all(dim=1)).sum())
    driver.release()
    del run.collected, p
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check()
    correct, compared = check.judge(numbers, lims)
    found = forbidden_modules()
    if found:
        print(f"vio_bench: modules of {found} are loaded", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in compared.items()}
    print(f"vio_bench: {run.ticks} ticks of {driver.rows} rows in "
          f"{window_s:.3f} s, set-up {setup_s:.3f} s, trace "
          f"{ {k: v for k, v in (run.trace or {}).items() if k != 'device_ops'} }, "
          f"kernels {run.kernels}", file=sys.stderr)
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
