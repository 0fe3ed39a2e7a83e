#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orcvio_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases:
 1. set-up: the card's name and power limit (nvidia-smi), TF32 off, the
    kernels built from orcvio_tpu_torch/csrc with nvcc;
 2. the port's main path, the front end at the bench configuration
    (752x480, 3 levels, 200 features, detection every 2nd frame, float32)
    over a seeded synthetic stream whose true flow is known: launch counts
    of both kernels, tracked features, flow error; a 20-frame scan under
    torch's sync debug mode, which must find no host synchronisation; then
    a small stream on the card against the same stream through the plain
    versions on the CPU;
 3. each kernel against its plain version on the card, on windows and
    positions cut from the main path's last frames;
 4. times with CUDA events: tracker ms/frame (21 scans), each kernel's
    time beside its bound, its plain version's and (K1) an
    advanced-indexing gather's. A bound counts the bytes and operations
    the kernel's function needs on this run's data: for K1 the image tiles
    its windows cover and the windows, for K2 the taps its template and
    its visited positions read, not the whole windows it is given.

Prints JSON lines; the last line is {"ok": true, "device": {...}}. Exits
non-zero, without that line, on any failed check, where CUDA is not
available, or where the port's package is missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
T_FRAMES = 120
SHIFT = (1.3, -0.7)        # true flow, px per frame
DEVICE = "cuda"
FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def synthetic_stream(T, H, W, shift, seed=0, sigma=2.0):
    """uint8 frames of a periodic band-limited texture translated by
    `shift` px per frame (exact subpixel shifts in the Fourier domain)."""
    rng = np.random.default_rng(seed)
    F = np.fft.rfft2(rng.normal(size=(H, W)))
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.rfftfreq(W)[None, :]
    F = F * np.exp(-(kx**2 + ky**2) * (2 * np.pi * sigma) ** 2 / 2)
    frames = np.stack([np.fft.irfft2(F * np.exp(
        -2j * np.pi * (kx * shift[0] * k + ky * shift[1] * k)), s=(H, W))
        for k in range(T)])
    lo, hi = frames.min(), frames.max()
    images = np.round((frames - lo) / (hi - lo) * 235.0 + 10.0)
    S = 16
    t = 1.0 + 0.05 * np.arange(T)  # 20 Hz
    imu_t = t[:, None] - 0.05 + (0.05 / S) * np.arange(1, S + 1)[None, :]
    gyro = np.zeros((T, S, 3))
    acc = np.tile([0.0, 0.0, 9.81], (T, S, 1))
    mask = np.ones((T, S), bool)
    return images.astype(np.uint8), t, imu_t, gyro, acc, mask


def tracked_flow(frames, K):
    """Per frame k >= 1: rows whose track id persists from frame k-1, and
    their pixel flow (zero distortion: pixel = normalized * f + c)."""
    fids = frames.fids.cpu().numpy()
    uvs = frames.uvs.cpu().numpy()
    f = np.asarray(K[:2])
    counts, flows = [], []
    for k in range(1, fids.shape[0]):
        same = (fids[k] >= 0) & (fids[k] == fids[k - 1])
        counts.append(int(same.sum()))
        flows.append((uvs[k][same] - uvs[k - 1][same]) * f)
    return np.asarray(counts), np.concatenate(flows)


def same_track_uv_err(run_a, run_b, K):
    """|uv_a - uv_b| in px over the observations of tracks that carry one id
    in one row in both runs and began at the same pixel in both (a
    detection may pick another of two equal scores on another device), and
    the number of tracks that began apart."""
    (fa, ua), (fb, ub) = run_a, run_b
    f = max(K[:2])
    errs, apart = [], set()
    for k in range(fa.shape[0]):
        for i in np.nonzero((fa[k] >= 0) & (fa[k] == fb[k]))[0]:
            first = int(np.argmax(fa[:, i] == fa[k, i]))
            if np.abs(ua[first, i] - ub[first, i]).max() * f > 1e-3:
                apart.add(int(fa[k, i]))
                continue
            errs.append(np.abs(ua[k, i] - ub[k, i]).max() * f)
    return np.asarray(errs), len(apart)


def time_ms(fn, reps=30, warmup=3, preload=True):
    """Median of `reps` single-call CUDA-event times, in ms. With preload,
    a spin kernel first keeps the stream busy while the host enqueues the
    call, so the time is the device's alone; without, it includes the
    host's time to issue the call."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if preload:
            torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def scan_syncs(scan, ts0, staged, n):
    """Host synchronisations inside an n-frame scan, as the file:line of each
    warning torch's sync debug mode raises there, and whether the mode
    caught a deliberate sync (an .item()) made after the scan."""
    import warnings

    import torch

    part = type(staged)(*(x[:n] for x in staged))

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                if "called a synchronizing" in str(w.message)]

    found = syncs(lambda: scan(ts0, part))
    control = syncs(lambda: torch.ones(1, device=DEVICE).sum().item())
    torch.cuda.synchronize()
    return found, bool(control)


def k1_needed_bytes(imgs, r0, c0, nr, nl):
    """Bytes K1's function must move: the distinct image tiles its windows
    cover, read once, the windows written once, and the (N,) indices."""
    import torch

    N = r0.shape[0]
    Hb, Wb = imgs.shape[1] // 8, imgs.shape[2] // 128
    cover = torch.zeros((Hb, Wb), dtype=torch.bool, device=imgs.device)
    rows = r0.long()[:, None] + torch.arange(nr, device=imgs.device)
    cols = c0.long()[:, None] + torch.arange(nl, device=imgs.device)
    cover[rows[:, :, None], cols[:, None, :]] = True
    tile = 8 * 128 * 4
    return int(cover.sum()) * tile + N * nr * nl * tile + 3 * N * 4


def k2_needed_bytes(win0, win1, aux, iters, P, eps, plain):
    """Bytes K2's function must move for this data: per feature the
    (P+3)^2 block of win0 its template reads and the union of the (P+1)^2
    blocks of win1 at every position it visits (the plain version run for
    0..iters steps gives them), aux read once and the (N, 8) output written
    once. Not the windows as stored: the function reads only these taps."""
    import torch

    N, R, L = win1.shape
    r = (P - 1) // 2
    seen = torch.zeros((N, R, L), dtype=torch.bool, device=win1.device)
    n = torch.arange(N, device=win1.device)[:, None, None]
    a = torch.arange(P + 1, device=win1.device)
    for k in range(iters + 1):
        pos = plain(win0, win1, aux, k, P, eps)[:, :2]
        ly = torch.clamp(pos[:, 1] - r, 0.0, R - 1.001 - P)
        lx = torch.clamp(pos[:, 0] - r, 0.0, L - 1.001 - P)
        rows = torch.floor(ly).long()[:, None] + a
        cols = torch.floor(lx).long()[:, None] + a
        seen[n, rows[:, :, None], cols[:, None, :]] = True
    win1_px = int(seen.sum())
    return (4 * (N * (P + 3) ** 2 + win1_px + aux.numel() + N * 8),
            win1_px / N)


def profile_frames(scan, ts0, staged, n):
    """Device busy share and kernel time by name over an n-frame scan."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    part = type(staged)(*(x[:n] for x in staged))
    scan(ts0, part)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan(ts0, part)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"frames": n, "wall_ms_per_frame": wall_ms / n,
            "device_ms_per_frame": busy_ms / n,
            "device_busy_share": busy_ms / wall_ms,
            "kernels_per_frame": sum(r[2] for r in rows) / n,
            "top": [{"name": k[:60], "ms_per_frame": ms / n,
                     "calls_per_frame": c / n} for k, ms, c in rows[:10]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from orcvio_tpu_torch import no_tf32
        from orcvio_tpu_torch.eval.staged import (
            make_tracker_scan, stage_sequence)
        from orcvio_tpu_torch.frontend import klt
        from orcvio_tpu_torch.frontend.detect import detect_grid
        from orcvio_tpu_torch.frontend.image import (
            build_pyramid, equalize_hist)
        from orcvio_tpu_torch.frontend.tracker import (
            TrackerConfig, TrackerState)
        from orcvio_tpu_torch.ops import _build
        from orcvio_tpu_torch.ops.dma_gather import (
            BL, BR, dma_gather_tiles, dma_gather_tiles_plain)
        from orcvio_tpu_torch.ops.lk_pallas import (
            lk_level_fused, lk_level_fused_plain)
        from orcvio_tpu_torch.ops.window_gather import window_origins
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 1

    # ---------------- 1. set-up ----------------
    gpu = gpu_line()
    print(gpu, flush=True)
    no_tf32()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    report = _build.build()
    emit({"build": {"seconds": round(time.perf_counter() - t0, 3),
                    "sources": sorted(report)}})
    for src, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)

    # ---------------- 2. the main path ----------------
    tc = TrackerConfig(height=480, width=752, pyramid_levels=3, capacity=200,
                       patch_size=15, klt_iters=10, grid_rows=8, grid_cols=10,
                       per_cell=3, min_distance=20.0, detect_every=2,
                       equalize=True, dist_model="radtan",
                       dist_coeffs=(0.0, 0.0, 0.0, 0.0))
    seq = synthetic_stream(T_FRAMES + 1, tc.height, tc.width, SHIFT)
    main_seq = tuple(x[:T_FRAMES] for x in seq)
    staged = stage_sequence(*main_seq, torch.float32, device=dev)
    R_b2c = np.eye(3)
    scan = make_tracker_scan(tc, R_b2c, torch.float32, device=dev)
    ts0 = TrackerState.create(tc, torch.float32, seed=0, device=dev)
    torch.cuda.synchronize()

    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    t0 = time.perf_counter()
    ts, frames = scan(ts0, staged)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"window_gather": dma_gather_tiles.launches,
                "lk_level": lk_level_fused.launches}

    T = T_FRAMES
    # per frame: 3 levels x (img0, img1) windows + 1 ORB gather; 3 forward
    # levels + 1 level-0 backward LK pass
    check(launches["window_gather"] == 7 * T,
          f"K1 launches {launches['window_gather']} == 7*T = {7 * T}")
    check(launches["lk_level"] == 4 * T,
          f"K2 launches {launches['lk_level']} == 4*T = {4 * T}")
    uvs = frames.uvs
    check(tuple(uvs.shape) == (T, 200, 2) and bool(torch.isfinite(uvs).all())
          and bool(torch.isfinite(frames.uv_vels).all()),
          "outputs finite, uvs (T, 200, 2)")
    check(bool((frames.meas_mask == (frames.fids >= 0)).all()),
          "meas_mask == fids >= 0")
    counts, flow = tracked_flow(frames, tc.K)
    flow_err = np.linalg.norm(flow - np.asarray(SHIFT), axis=1)
    med_tracked = float(np.median(counts))
    med_err = float(np.median(flow_err))
    check(med_tracked >= 100, f"median tracked features {med_tracked} >= 100")
    check(med_err < 0.1, f"median flow error {med_err:.4f} px < 0.1")
    emit({"main_path": {"frames": T, "first_run_s": first_s,
                        "launches": launches,
                        "tracked_median": med_tracked,
                        "tracked_min": int(counts.min()),
                        "flow_err_median_px": med_err,
                        "flow_err_p90_px": float(np.quantile(flow_err, 0.9)),
                        "next_id": int(ts.next_id)}})

    # the frame loop waits for the card nowhere (caches are warm after the
    # first run, so any sync here would be one per frame)
    syncs, control = scan_syncs(scan, ts0, staged, 20)
    check(control and not syncs,
          f"no host synchronisation in a 20-frame scan ({len(syncs)} found: "
          f"{sorted(set(syncs))[:5]}; a deliberate .item() was "
          f"{'caught' if control else 'missed'})")

    # small stream: card (kernels) against CPU (plain versions), same draws
    stc = tc._replace(height=120, width=160, pyramid_levels=2, capacity=32,
                      grid_rows=4, grid_cols=4)
    small = synthetic_stream(6, stc.height, stc.width, (2.1, -1.4), seed=1)
    gumbel = np.random.default_rng(2).gumbel(size=(6, 128, 8, 32))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        _, fr = make_tracker_scan(stc, R_b2c, torch.float32, device=d)(
            TrackerState.create(stc, torch.float32, device=d),
            stage_sequence(*small, torch.float32, device=d),
            ransac_gumbel=torch.as_tensor(gumbel, dtype=torch.float32,
                                          device=d))
        res[name] = (fr.fids.cpu().numpy(), fr.uvs.cpu().numpy())
    same_ids = res["cuda"][0] == res["cpu"][0]
    check(same_ids.mean() >= 0.95,
          f"small stream: fids equal on {same_ids.mean():.3f} >= 0.95 of rows")
    uv_err, n_apart = same_track_uv_err(res["cuda"], res["cpu"], stc.K)
    check(uv_err.size >= 0.5 * same_ids.size and uv_err.max() < 0.05,
          f"small stream: {uv_err.size} observations of tracks that began at "
          f"one pixel on both, max uv diff {uv_err.max():.2e} px < 0.05 "
          f"({n_apart} tracks began at other pixels)")

    # ---------------- 3. kernels against plain versions ----------------
    # windows and positions of the main path's next frame, at every level
    nxt = torch.as_tensor(seq[0][T], device=dev).to(torch.float32)
    img1 = equalize_hist(nxt)
    pyr1 = klt.prepare_pyramid(build_pyramid(img1, tc.pyramid_levels))
    xy0 = ts.xy
    k1_cases, k2_cases = [], []
    p1 = xy0 / 2.0 ** (tc.pyramid_levels - 1)
    for lv in range(tc.pyramid_levels - 1, -1, -1):
        if lv != tc.pyramid_levels - 1:
            p1 = p1 * 2.0
        p0 = xy0 / 2.0 ** lv
        for ai, c in ((ts.pyr[lv], p0), (pyr1[lv], p1)):
            r0, c0, _ = window_origins(ai, c, -(klt.SEARCH_WD // 2), 48, 256)
            k1_cases.append((f"L{lv}", ai.padded, r0, c0))
        lw0 = klt.gather_level(ts.pyr[lv], p0)
        lw1 = klt.gather_level(pyr1[lv], p1)
        aux, lo, hi = klt._level_aux(lw0, lw1, p0, p1, tc.patch_size)
        k2_cases.append((f"L{lv}", lw0, lw1, aux, lo, hi))
        out = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters,
                             tc.patch_size, klt.KLT_EPS)
        p1 = klt._level_result(out, lw1, lo, hi)[0]
    # ORB reads 440 windows: the 200 tracked positions + 240 candidates
    det_xy = detect_grid(img1, tc.per_cell, tc.grid_rows, tc.grid_cols)[0]
    r0, c0, _ = window_origins(pyr1[0], torch.cat([p1, det_xy]), -16, 48,
                               256)
    k1_cases.append(("ORB", pyr1[0].padded, r0, c0))

    k1_exact = True
    for name, imgs, r0, c0 in k1_cases:
        b = torch.zeros_like(r0)
        a = dma_gather_tiles(imgs, r0, c0, b, 6, 2)
        p = dma_gather_tiles_plain(imgs, r0, c0, b, 6, 2)
        exact = bool(torch.equal(a, p))
        k1_exact &= exact
        check(exact, f"K1 {name} {tuple(imgs.shape)} N={r0.shape[0]}: "
                     "bit-exact against the plain version")
    empty = dma_gather_tiles(k1_cases[0][1], r0[:0], c0[:0], r0[:0], 6, 2)
    check(tuple(empty.shape) == (0, 48, 256), "K1 N=0 returns (0, 48, 256)")

    k2_err = {}
    for eps, tol in ((0.0, 1e-3), (klt.KLT_EPS, 2e-2)):
        worst = 0.0
        for name, lw0, lw1, aux, lo, hi in k2_cases:
            a = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters,
                               tc.patch_size, eps)
            p = lk_level_fused_plain(lw0.win, lw1.win, aux, tc.klt_iters,
                                     tc.patch_size, eps)
            err = float((a[:, :2] - p[:, :2]).abs().max())
            worst = max(worst, err)
            ca = klt._level_result(a, lw1, lo, hi)[2]
            cp = klt._level_result(p, lw1, lo, hi)[2]
            agree = float((ca == cp).float().mean())
            check(err < tol and agree >= 0.99,
                  f"K2 {name} eps={eps}: max |dpos| {err:.2e} < {tol}, "
                  f"conv agree {agree:.3f} >= 0.99")
        k2_err[eps] = worst
    torch.cuda.synchronize()

    # ---------------- 4. times ----------------
    reps_scan = 21
    ev = []
    for _ in range(reps_scan):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        scan(ts0, staged)
        e1.record()
        ev.append((e0, e1))
    torch.cuda.synchronize()
    per_frame = np.asarray([a.elapsed_time(b) / T for a, b in ev])
    emit({"tracker": {"ms_per_frame": float(np.median(per_frame)),
                      "min": float(per_frame.min()),
                      "p10": float(np.quantile(per_frame, 0.1)),
                      "p90": float(np.quantile(per_frame, 0.9)),
                      "max": float(per_frame.max()), "scans": reps_scan,
                      "frames": T,
                      "config": "752x480, 3 levels, 200 features, f32"}})

    # K1 at the main path's level-0 KLT shape, and the ORB shape
    _, imgs, r0, c0 = k1_cases[-2]  # level 0, the new frame
    b = torch.zeros_like(r0)
    N = r0.shape[0]
    k1_ms = time_ms(lambda: dma_gather_tiles(imgs, r0, c0, b, 6, 2))
    k1_call_ms = time_ms(lambda: dma_gather_tiles(imgs, r0, c0, b, 6, 2),
                         preload=False)
    k1_plain_ms = time_ms(lambda: dma_gather_tiles_plain(imgs, r0, c0, b, 6,
                                                         2), reps=20,
                          preload=False)
    rows = r0.long()[:, None] * BR + torch.arange(48, device=dev)
    cols = c0.long()[:, None] * BL + torch.arange(256, device=dev)
    bl = b.long()[:, None, None]
    ri, ci = rows[:, :, None], cols[:, None, :]
    lib = imgs[bl, ri, ci]
    check(bool(torch.equal(lib, dma_gather_tiles(imgs, r0, c0, b, 6, 2))),
          "K1 yardstick gather equals the kernel")
    k1_lib_ms = time_ms(lambda: imgs[bl, ri, ci])
    k1_bytes = k1_needed_bytes(imgs, r0, c0, 6, 2)
    _, oimgs, or0, oc0 = k1_cases[-1]
    ob = torch.zeros_like(or0)
    k1_orb_ms = time_ms(lambda: dma_gather_tiles(oimgs, or0, oc0, ob, 6, 2))

    # K2 at level 0 with the main path's eps; ops counted from the steps
    # this data takes
    _, lw0, lw1, aux, lo, hi = k2_cases[-1]
    N2 = aux.shape[0]
    P = tc.patch_size
    k2_out = lk_level_fused(lw0.win, lw1.win, aux, tc.klt_iters, P,
                            klt.KLT_EPS)
    steps = float(k2_out[:, 5].sum())
    k2_call = lambda: lk_level_fused(lw0.win, lw1.win, aux,  # noqa: E731
                                     tc.klt_iters, P, klt.KLT_EPS)
    k2_ms = time_ms(k2_call)
    k2_call_ms = time_ms(k2_call, preload=False)
    k2_plain_ms = time_ms(lambda: lk_level_fused_plain(
        lw0.win, lw1.win, aux, tc.klt_iters, P, klt.KLT_EPS), reps=20,
        preload=False)
    k2_bytes, win1_px = k2_needed_bytes(lw0.win, lw1.win, aux, tc.klt_iters,
                                        P, klt.KLT_EPS, lk_level_fused_plain)
    # template: (P+2)^2 bilinear taps (9 ops) + P^2 differences and Hessian
    # terms (10); per step: P^2 taps of bilinear, error and two products
    # (14) + the 2x2 solve (20); residual: P^2 x 12
    k2_ops = (N2 * ((P + 2) ** 2 * 9 + P * P * 10 + P * P * 12)
              + steps * (P * P * 14 + 20))

    def bound(nbytes, ops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = ops / FP32_FLOP_PER_S * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    k1_bound, k1_by = bound(k1_bytes, 0)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    kernels = [
        {"name": "window_gather", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/window_gather.cu",
         "replaces": "orcvio_tpu/ops/dma_gather.py:77",
         "launches": launches["window_gather"],
         "max_abs_err": 0.0 if k1_exact else None,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms,
         "shape": f"({N},48,256) from {tuple(imgs.shape)}",
         "bytes": k1_bytes, "call_ms": k1_call_ms, "orb_ms": k1_orb_ms,
         "orb_shape": f"({or0.shape[0]},48,256)",
         "check": "bit-exact at 3 levels x 2 images + ORB"},
        {"name": "lk_level", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/lk_level.cu",
         "replaces": "orcvio_tpu/ops/lk_pallas.py:223",
         "launches": launches["lk_level"],
         "max_abs_err": k2_err[klt.KLT_EPS],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "shape": f"win0/win1 ({N2},48,256), aux ({N2},16)",
         "bytes": k2_bytes, "ops": k2_ops,
         "win1_px_per_feature": win1_px, "call_ms": k2_call_ms,
         "steps_mean": steps / N2, "steps_max": float(k2_out[:, 5].max()),
         "max_abs_err_eps0": k2_err[0.0],
         "check": "positions vs plain: eps=0 < 1e-3 px, eps=0.01 < 2e-2 px;"
                  " conv agree >= 99%"},
    ]
    emit({"kernels": kernels})
    try:
        emit({"profile": profile_frames(scan, ts0, staged, 10)})
    except RuntimeError as e:  # the profiler is optional here: no check
        emit({"profile": f"unavailable: {e}"})

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:",
              file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
