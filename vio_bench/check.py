"""The comparisons that decide ``correct``, and the judgement against the
limits (``vio_bench/limits/<workload>.json``, one file a cell). Each number
compares what the program produced with what the plain reference
produced from the same inputs; nothing here imports the port."""
from __future__ import annotations

import math

import numpy as np


def filter_rel(prog: dict, ref: dict) -> float:
    """Largest gap between two filter states (dicts of arrays, as
    ``reference/msckf.py`` holds them): over the IMU's R, v, p and biases,
    the valid clones' R and p, and the covariance P. Each block's gap is
    taken against the reference's largest entry of that block or of the
    median block, whichever is larger, since the biases are all but zero.
    A clone window that differs (another slot valid, another insertion
    order) is a gap without bound: inf."""
    if not (np.array_equal(prog["cvalid"], ref["cvalid"])
            and np.array_equal(prog["corder"], ref["corder"])):
        return math.inf
    c = ref["cvalid"]
    pairs = [(np.asarray(prog[k], np.float64), np.asarray(ref[k], np.float64))
             for k in ("R", "v", "p", "bg", "ba", "P")]
    pairs += [(np.asarray(prog[k], np.float64)[c],
               np.asarray(ref[k], np.float64)[c]) for k in ("cR", "cp")]
    pairs = [(a, b) for a, b in pairs if b.size]
    scales = [float(np.abs(b).max()) for _, b in pairs]
    floor = max(float(np.median(scales)), 1e-30)
    worst = 0.0
    for (a, b), scale in zip(pairs, scales):
        gap = float(np.abs(a - b).max()) / max(scale, floor)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def worst(values: dict, name: str, value: float) -> None:
    """values[name] = the larger of it and value (NaN counts as inf)."""
    value = value if math.isfinite(value) else math.inf
    values[name] = max(values.get(name, 0.0), value)


def judge(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}}): correct where every
    number the cell's limits name is present, finite and within its
    limit."""
    out, ok = {}, True
    for name, lim in lims.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out
