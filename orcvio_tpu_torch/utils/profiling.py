"""Tracing and profiling utilities.

Counterpart of ``orcvio_tpu/utils/profiling.py`` (the reference times its
loop with cv::getTickCount, app/orcvioMain.cpp:131-182): a
``torch.profiler`` trace written as a Chrome trace, the named spans the
main path marks its stages with, and the online RMSE/NEES accumulators of
the reference's System.
"""
from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

SPAN_PREFIX = "orcvio::"
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A profiler range named ``orcvio::<name>`` around a stage, while
    torch's profiler runs (``trace`` above, or any torch.profiler.profile);
    otherwise a shared no-op context manager, so a span that is off costs
    one check of a C-level flag. The range lies on the profiler's own
    timeline, the clock its device events are converted to, and is kept in
    the profiler's memory like its other events. Under torch.func.vmap one
    range is recorded per call, not per row.

    >>> with span("filter.update"):
    ...     state, dx = msckf_update(cfg, state, fj, use_k)
    """
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(SPAN_PREFIX + name)


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
