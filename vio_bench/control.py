"""The readings the limits are set from: for each seed, a cell's set-up and
a short window at its own load, then every compared number twice, of the
program and of the control (the plain reference one precision step down,
float32 for the configuration's float64, put in the program's place). One process reads all the seeds.

    python3 vio_bench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--out FILE]

Prints one JSON line a seed, {"seed", "ticks", "program", "control"},
and appends them to FILE where given. Not part of a benchmark run.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(workload, seeds, seconds, device="cuda",
             bench_path=None, data=None, out=None):
    """[{"seed", "ticks", "program", "control"}] of each seed."""
    import importlib

    import torch

    from vio_bench import harness

    cell, cfg, mix, *_ = harness.load_cell(
        workload, bench_path or harness.ROOT / "BENCHMARK.json",
        data or harness.HERE)
    drivers = importlib.import_module(f"vio_bench.drivers.{mix['driver']}")
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        driver = drivers.Driver(cfg, mix, seed, device)
        for _ in range(mix["warm_ticks"]):
            driver.tick()
        driver.restart()
        run = harness.Run(driver.rows)
        driver.arm(seed)
        harness.window(driver, seconds, run)
        while driver.sampler.pending():
            driver.tick()
        driver.release()
        if device == "cuda":
            torch.cuda.empty_cache()
        line = {"seed": seed, "ticks": run.ticks,
                "program": driver.check(),
                "control": driver.check(control=True),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(line) + "\n")
        lines.append(line)
        del driver, run
    return lines


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             out=a.out)
