"""What the benchmark reads from torch.profiler's trace: the union of the
device's activity, kernels by name, the kernels launched inside the
benchmark's own ranges, and the longest idle gaps with the host op under
way. Events are read in memory from the profiler's raw results (the
method of chip_smoke.py:873-906, ``device_rows``); no trace file is
written. Nothing here imports the port.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

import torch

RANGE_PREFIX = "vio_bench::"
COPIES = ("Memcpy", "Memset")  # device events that are not kernels


def _annotation(e) -> bool:
    """A range (a record_function's, or the device-side image of one the
    profiler adds), which spans events counted on their own."""
    return (getattr(e, "is_user_annotation", lambda: False)()
            or getattr(e, "is_hidden_event", lambda: False)())


def _on_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def device_events(prof):
    """[(name, start_ns, end_ns, is_kernel)] of every kernel, copy and set
    the trace holds, ranges left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not _on_device(e) or _annotation(e):
            continue
        start, name = e.start_ns(), e.name()
        out.append((name, start, start + e.duration_ns(),
                    not name.startswith(COPIES)))
    return out


def union(intervals) -> tuple[float, list]:
    """(seconds covered by the union of [start_ns, end_ns) intervals, the
    merged intervals in order)."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e9, merged


def by_name(events) -> list:
    """[[name, seconds]] of device time by op name (its first 160
    characters), largest first."""
    acc = {}
    for name, a, b, *_ in events:
        acc[name[:160]] = acc.get(name[:160], 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in acc.items()), key=lambda r: -r[1])


def profile_ticks(tick, n: int, host: bool):
    """Trace n calls of tick(), the CUDA activity only unless host, between
    two synchronisations. Returns (profile, window_s on the host clock)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof, window_s


def unbatched(x):
    """(x's tensor with the batch of torch.func.vmap first, its rows) for
    a batched tensor inside vmap; (x, None) for anything else."""
    from torch._C._functorch import (get_unwrapped, is_batchedtensor,
                                     maybe_get_bdim)

    if not torch.is_tensor(x) or not is_batchedtensor(x):
        return x, None
    rows = 1
    while is_batchedtensor(x):
        d = maybe_get_bdim(x)
        x = get_unwrapped(x).movedim(d, 0)
        rows *= x.shape[0]
    return x, rows


class Ranges:
    """Profiler ranges ("vio_bench::<name>") around the calls of a
    program's entry, installed by rebinding the name its caller calls it
    by. Each call's arguments are kept for the operation count as
    (args, batched flags, kwargs, rows): under vmap each batched argument
    with its rows first, and rows the batch's size (1 outside vmap)."""

    def __init__(self):
        self.calls: dict[str, list] = {}

    @contextmanager
    def around(self, name: str, module, attr: str):
        from torch.autograd.profiler import record_function

        inner = getattr(module, attr)
        calls = self.calls.setdefault(name, [])

        def wrapped(*args, **kwargs):
            un = [unbatched(a) for a in args]
            rows = max([r for _, r in un if r] or [1])
            calls.append(([a for a, _ in un], [r is not None for _, r in un],
                          kwargs, rows))
            with record_function(RANGE_PREFIX + name):
                return inner(*args, **kwargs)

        setattr(module, attr, wrapped)
        try:
            yield
        finally:
            setattr(module, attr, inner)


def range_kernel_seconds(prof) -> dict:
    """{range name: device seconds of the kernels launched inside it}: a
    kernel belongs to a range when the host call that launched it (the
    runtime event of its correlation id) lies inside one of the range's
    host intervals. Also returns, under None, how many kernels found
    their launch."""
    ranges, launch_at, kernels = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _on_device(e):
            if not _annotation(e):
                kernels.append((e.correlation_id(), e.duration_ns()))
        elif name.startswith(RANGE_PREFIX):
            ranges.setdefault(name[len(RANGE_PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu") and "Launch" in name:
            # the runtime's launch call, whose id the kernel carries
            launch_at[e.correlation_id()] = e.start_ns()
    out = {}
    for name, spans in ranges.items():
        spans.sort()
        starts = [a for a, _ in spans]
        total = 0
        for corr, dur in kernels:
            t = launch_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += dur
        out[name] = total / 1e9
    out[None] = sum(c in launch_at for c, _ in kernels)
    return out


def idle_gaps(prof, merged, k: int = 10) -> list:
    """The k longest gaps between the device's busy intervals, each as
    [the innermost host op under way at the gap's middle, seconds]."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if not _on_device(e) and e.name().startswith(("aten::",
                                                       RANGE_PREFIX)):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    ops.sort()
    starts = [a for a, _, _ in ops]
    gaps = sorted(((b2 - a2, a2, b2) for (_, a2), (b2, _) in
                   zip(merged, merged[1:])), reverse=True)[:k]
    out = []
    for dur, a, b in gaps:
        mid = (a + b) // 2
        # the latest-starting op that still runs at mid is the innermost
        name = next((n for _, e, n in reversed(
            ops[:bisect.bisect_right(starts, mid)]) if e >= mid),
            "(no host op)")
        out.append([name, dur / 1e9])
    return out
