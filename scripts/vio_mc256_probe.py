"""Set-up's parts and the rows' spread in the benchmark's vio_mc256 cell,
on the card:

    python3 scripts/vio_mc256_probe.py --seed <n> [--ticks 96]

Builds the cell's driver (``vio_bench/drivers/e2e_replay.py``) as the
harness does and times its parts: the stream made on the device
(``vio_bench/stream.py:make``), the batched replay's build, and each
set-up frame (the first holds the kernels' builds). Then it runs the
window's first ticks and, after each, takes every row's largest gap from
row 0: the positions of the tracks both keep, the ids, the RANSAC inlier
counts, the filter's position, covariance and in-state inverse depths.
Prints one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "vio_bench" / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from orcvio_tpu_torch.eval import staged  # noqa: E402
from vio_bench import harness, stream  # noqa: E402
from vio_bench.drivers import e2e_replay  # noqa: E402


def timed(log: dict, name: str, fn):
    """fn, each call's seconds appended to log[name] (synchronised)."""
    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        log.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    return wrapped


def gaps(ts, vs) -> dict:
    """Each quantity's largest gap of any row from row 0, and the number
    of rows that differ from row 0 in anything read here."""
    def off(x):
        x = torch.nan_to_num(x.to(torch.float64))
        return (x - x[:1]).abs().flatten(1)

    f, ft = vs.filter, vs.filter.features
    kept = (ts.fid == ts.fid[:1]) & (ts.fid >= 0)
    parts = {"fid": off(ts.fid), "xy": off(ts.xy * kept[..., None]),
             "uvn": off(ts.uvn * kept[..., None]), "p": off(f.imu.p),
             "R": off(f.imu.R), "P": off(f.P), "in_state": off(ft.in_state),
             "idp": off(ft.idp)}
    out = {k: float(v.max()) for k, v in parts.items()}
    out["rows"] = int(torch.stack([v.amax(1) > 0 for v in parts.values()])
                      .any(0).sum())
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ticks", type=int, default=96)
    args = ap.parse_args()
    t_start = harness.process_start()
    _, cfg, mix, *_ = harness.load_cell("vio_mc256")
    log = {}
    stream.make = timed(log, "stream_s", stream.make)
    make = staged.make_batched_e2e_replay

    def build(*a, **k):
        return timed(log, "frames_s", timed(log, "build_s", make)(*a, **k))

    staged.make_batched_e2e_replay = build
    t0 = time.perf_counter()
    d = e2e_replay.Driver(cfg, mix, args.seed, "cuda")
    driver_s = time.perf_counter() - t0
    S = mix["setup_frames"]
    frames = log["frames_s"][:S]
    setup = {"imports_s": t0 - t_start, "driver_s": driver_s,
             "stream_s": sum(log["stream_s"]), "build_s": sum(log["build_s"]),
             "first_frame_s": frames[0], "other_frames_s": sum(frames[1:])}
    setup["rest_s"] = driver_s - sum(v for k, v in setup.items()
                                     if k not in ("imports_s", "driver_s"))
    for _ in range(mix["warm_ticks"]):
        d.tick()
    d.restart()
    at_snapshot = gaps(*d.state)
    d.collecting = True
    worst, differ = {}, 0
    for _ in range(args.ticks):
        d.tick()
        g = gaps(*d.state)
        differ += g["rows"] > 0
        worst = {k: max(worst.get(k, 0), v) for k, v in g.items()}
    inl = torch.cat(d.collected["n_inliers"], 1).to(torch.float64)
    print(json.dumps({
        "card": card(), "seed": args.seed, "setup": setup,
        "snapshot_gaps": at_snapshot, "ticks": args.ticks,
        "ticks_with_rows_differing": int(differ), "worst_gaps": worst,
        "inliers_rows_differing_ticks": int(
            ((inl - inl[:1]).abs().amax(0) > 0).sum()),
        "frame_reached": d.frame}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
