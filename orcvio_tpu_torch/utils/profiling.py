"""Tracing and profiling utilities.

Counterpart of ``orcvio_tpu/utils/profiling.py`` (the reference times its
loop with cv::getTickCount, app/orcvioMain.cpp:131-182): a
``torch.profiler`` trace written as a Chrome trace, a stage timer that
waits for the card where a stage's output lives there, and the online
RMSE/NEES accumulators of the reference's System.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict

import numpy as np
import torch
import torch.utils._pytree as pytree


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block with torch.profiler (the card's activity too where
    there is one) and write it to logdir as a Chrome trace
    (``trace_<pid>_<ns>.json``, for chrome://tracing or Perfetto). Yields
    the profiler; its ``path`` attribute names the file once the block
    is done."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.path = os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.path)


def _on_cuda(tree) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in pytree.tree_leaves(tree))


class StageTimer:
    """Wall-clock seconds per named stage. A stage that puts its output in
    box["out"] is timed to that output's completion: where it holds CUDA
    tensors, the card is synchronized first.

    >>> t = StageTimer()
    >>> with t.stage("frontend") as box:
    ...     box["out"] = track(...)
    >>> t.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "out" in box and _on_cuda(box["out"]):
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:20s} {tot:8.3f}s total  "
                         f"{tot / max(n, 1) * 1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)


class OnlineMetrics:
    """Incremental RMSE/NEES against groundtruth (the reference System's
    online accumulators, ros_wrapper/src/orcvio/src/System.cpp:389-392,
    918-940 -> temp_rmse.txt)."""

    def __init__(self):
        self.sq_pos = 0.0
        self.sq_rot = 0.0
        self.nees_pos = 0.0
        self.n = 0

    def update(self, p_est, R_est, p_gt, R_gt, P_pos=None):
        e = np.asarray(p_est) - np.asarray(p_gt)
        self.sq_pos += float(e @ e)
        Rrel = np.asarray(R_est).T @ np.asarray(R_gt)
        cos_t = np.clip((np.trace(Rrel) - 1) / 2, -1, 1)
        self.sq_rot += float(np.degrees(np.arccos(cos_t)) ** 2)
        if P_pos is not None:
            self.nees_pos += float(e @ np.linalg.solve(np.asarray(P_pos), e))
        self.n += 1

    def summary(self):
        n = max(self.n, 1)
        return {"rmse_pos_m": math.sqrt(self.sq_pos / n),
                "rmse_rot_deg": math.sqrt(self.sq_rot / n),
                "nees_pos": self.nees_pos / n,
                "n": self.n}

    def write(self, path: str):
        s = self.summary()
        with open(path, "w") as f:
            f.write(f"{s['rmse_rot_deg']:.6f} {s['rmse_pos_m']:.6f} "
                    f"{s['nees_pos']:.6f} {s['n']}\n")
        return s
