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
    its visited positions read, not the whole windows it is given; then
    the tracker profiled over 10 frames;
 5. the slice's main path, the end-to-end replay (tracker, static init,
    filter) at the bench configuration in float32, over a bench-like
    stream rendered on the card (300 frames, 60 of them static): init,
    finite poses, the ATE against the JAX package's on the same stream,
    the launch count of every kernel; ms/frame over 7 replays of 100
    flight frames after init; 20 of them under sync debug mode; 10 of them
    profiled;
 6. K4 against its plain version on the (P, K, H) the replay gave it (the
    stacked, last-chance and ZUPT updates) and on random (172, 444)
    inputs in float32 and float64, within the rounding bound and exactly
    symmetric; its times beside its bound.

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

# the front end at the bench configuration (bench.py:155-163)
TRACKER = dict(height=480, width=752, pyramid_levels=3, capacity=200,
               patch_size=15, klt_iters=10, grid_rows=8, grid_cols=10,
               per_cell=3, min_distance=20.0, detect_every=2, equalize=True,
               dist_model="radtan", dist_coeffs=(0.0, 0.0, 0.0, 0.0))

# The end-to-end stream: the bench sequence of scripts/make_bench_seq.py:31-36
# (3 s static, then flight at 4 m over a textured ground plane) with the
# camera, texture, extrinsics, biases and image noise of
# orcvio_tpu/dataio/euroc_writer.py:28-56, cut to E2E_FRAMES frames. Its
# timestamps start at 0.05 s, so float32 holds them: no rebase as bench.py
# does for EuRoC epochs.
E2E_FRAMES = 300
E2E_WINDOW = 100  # flight frames after init per timed replay
BENCH_SIM = dict(frame_hz=20.0, imu_hz=200.0, static_time=3.0,
                 ramp_time=1.5, height=4.0, radius=2.5, omega=0.5, seed=11,
                 gyro_noise=0.0024, acc_noise=0.028)
CAM_K = (458.0, 458.0, 376.0, 240.0)
R_B2C_DOWN = ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0))
T_C_B = (0.03, 0.01, 0.0)
TEXTURE = dict(size=2048, scale=0.012, seed=4)
IMAGE_NOISE = 1.5
GYRO_BIAS = (0.002, -0.0015, 0.001)
ACC_BIAS = (0.02, -0.015, 0.025)
# the filter flags of the bench's config.yaml (euroc_writer.py:186-216, read
# by config/yaml_io.py:load_reference_yaml: D = 22 + 6*20 + 30 = 172) and
# the bench's IMU slab (bench.py:153)
BENCH_FILTER = dict(imu_slab=16, use_larvio=True, use_left_perturbation=False,
                    use_closed_form_cov_prop=True, if_zupt=True,
                    observation_noise=0.008, init_cov_extrin_rot=3.0462e-8,
                    init_cov_extrin_trans=9e-8, tri_translation_threshold=-1.0,
                    max_grid_features=1, feature_idp_dim=1, ekf_feature_cap=30)
# The JAX package's ATE on this stream: its make_e2e_replay in float32 on a
# CPU (the same stream rendered by its own renderer), posyaw alignment over
# all frames, from `python tests/test_torch_e2e.py --jax-bench-ate`.
JAX_E2E = {"ate_m": 0.051423995215992765, "init_frame": 20,
           "filter_frames": 279, "n_upd_total": 1262, "zupt_frames": 43}
# The port passes where its ATE is at most this much above the JAX figure,
# about twice it: the RANSAC draws differ between the packages, so the two
# runs track other features and differ as two seeds of one filter do.
ATE_MARGIN_M = 0.05


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


def bin_imu(frame_ts, imu_ts, gyro, acc, slab, imu_rate=200.0):
    """Frame k gets the samples in (t_{k-1}, t_k + 0.5 / imu_rate], the
    newest `slab` of them, zero-padded: (imu_t, gyro, acc, mask) of shapes
    (T, slab[, 3]), as orcvio_tpu/dataio/euroc.py:bin_imu_per_frame."""
    T = len(frame_ts)
    out_t, out_m = np.zeros((T, slab)), np.zeros((T, slab), bool)
    out_g, out_a = np.zeros((T, slab, 3)), np.zeros((T, slab, 3))
    ends = np.searchsorted(imu_ts, frame_ts + 0.5 / imu_rate, side="right")
    start = 0
    for k, end in enumerate(ends):
        lo = max(start, end - slab)
        n = end - lo
        out_t[k, :n], out_g[k, :n] = imu_ts[lo:end], gyro[lo:end]
        out_a[k, :n], out_m[k, :n] = acc[lo:end], True
        start = end
    return out_t, out_g, out_a, out_m


def bench_stream(n, pose_fn, imu_fn, render_fn, sim=None):
    """The end-to-end stream of n frames, as
    orcvio_tpu/dataio/euroc_writer.py:write_euroc_dataset makes it, in
    memory: pose_fn(t) -> (R (n,3,3), p (n,3)) and imu_fn(t) -> (gyro,
    acc) of the trajectory, render_fn(R_c2w, t_c_w) -> float32 (H, W) view
    of the ground plane. One numpy generator adds the IMU noise and biases,
    then each frame's image noise. sim: the SimConfig fields (default
    BENCH_SIM). Returns (images (n, H, W) uint8, frame_ts, imu_t, gyro,
    acc, mask, gt_R, gt_p)."""
    sim = BENCH_SIM if sim is None else sim
    hz, imu_hz = sim["frame_hz"], sim["imu_hz"]
    frame_ts = (np.arange(n) + 1) / hz
    imu_ts = (1 + np.arange(int(round((n + 1) / hz * imu_hz)))) / imu_hz
    gt_R, gt_p = (np.asarray(x, np.float64) for x in pose_fn(frame_ts))
    gyro, acc = (np.asarray(x, np.float64) for x in imu_fn(imu_ts))
    rng = np.random.default_rng(sim["seed"] + 100)
    gyro = (gyro + rng.normal(size=gyro.shape) * sim["gyro_noise"]
            + np.asarray(GYRO_BIAS))
    acc = (acc + rng.normal(size=acc.shape) * sim["acc_noise"]
           + np.asarray(ACC_BIAS))
    R_b2c, t_c_b = np.asarray(R_B2C_DOWN), np.asarray(T_C_B)
    images = []
    for k in range(n):
        img = np.asarray(render_fn(gt_R[k] @ R_b2c.T, gt_p[k] + gt_R[k] @ t_c_b))
        img = img + rng.normal(size=img.shape) * IMAGE_NOISE
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    slabs = bin_imu(frame_ts, imu_ts, gyro, acc, BENCH_FILTER["imu_slab"],
                    imu_hz)
    return (np.stack(images), frame_ts, *slabs, gt_R, gt_p)


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


def find_syncs(fn):
    """Host synchronisations inside fn(), as the file:line of each warning
    torch's sync debug mode raises there."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def check_no_syncs(fn, what):
    """Fail unless fn() makes no host synchronisation, while the debug mode
    does catch a deliberate one (an .item()) made after it."""
    import torch

    syncs = find_syncs(fn)
    control = find_syncs(lambda: torch.ones(1, device=DEVICE).sum().item())
    check(bool(control) and not syncs,
          f"no host synchronisation in {what} ({len(syncs)} found: "
          f"{sorted(set(syncs))[:5]}; a deliberate .item() was "
          f"{'caught' if control else 'missed'})")


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


def profile_frames(run, n):
    """Device busy share and kernel time by name over run(), n frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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


def k4_tolerance(P, K, HP, out):
    """Per-element bound on |kernel - plain| for sym(P - K HP): each forms
    A(r, c) and A(c, r) as length-q sums in its own order, so each is off
    the exact value by at most gamma_{q+2} (|K| |HP| + |P|) entry by entry
    (gamma_n = n u / (1 - n u)), plus a rounding of the mean; the two
    outputs differ by at most twice that."""
    import torch

    u = torch.finfo(P.dtype).eps / 2
    n = K.shape[1] + 2
    g = n * u / (1 - n * u)
    M = K.double().abs() @ HP.double().abs() + P.double().abs()
    return 2 * (g * 0.5 * (M + M.T) + u * out.double().abs())


def k4_inputs(D, q, seed, dtype, dev):
    """Random (P, K, H) as tests/test_torch_cov_update.py draws them."""
    import torch

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in (
        A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
        rng.normal(size=(q, D)) * 0.1))


def bound_ms(nbytes, ops):
    """(the least time in ms for `nbytes` of memory traffic and `ops`
    float32 operations, and which of the two sets it)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_FLOP_PER_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from orcvio_tpu_torch import no_tf32
        from orcvio_tpu_torch.config.core import FilterConfig
        from orcvio_tpu_torch.dataio import synthetic as syn
        from orcvio_tpu_torch.eval.staged import (
            make_e2e_replay, make_tracker_scan, stage_sequence)
        from orcvio_tpu_torch.eval.trajectory import ate
        from orcvio_tpu_torch.filter import update as filter_update
        from orcvio_tpu_torch.frontend import klt
        from orcvio_tpu_torch.frontend.detect import detect_grid
        from orcvio_tpu_torch.frontend.image import (
            build_pyramid, equalize_hist)
        from orcvio_tpu_torch.frontend.tracker import (
            TrackerConfig, TrackerState)
        from orcvio_tpu_torch.math import quat
        from orcvio_tpu_torch.ops import _build
        from orcvio_tpu_torch.ops.cov_update import (
            cov_update, cov_update_plain)
        from orcvio_tpu_torch.ops.dma_gather import (
            BL, BR, dma_gather_tiles, dma_gather_tiles_plain)
        from orcvio_tpu_torch.ops.lk_pallas import (
            lk_level_fused, lk_level_fused_plain)
        from orcvio_tpu_torch.ops.window_gather import window_origins
        from orcvio_tpu_torch.vio import VioState
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
    tc = TrackerConfig(**TRACKER)
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
    part = type(staged)(*(x[:20] for x in staged))
    check_no_syncs(lambda: scan(ts0, part), "a 20-frame scan")

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

    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    k2_bound, k2_by = bound_ms(k2_bytes, k2_ops)
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
    part10 = type(staged)(*(x[:10] for x in staged))
    tracker_profile = profile_frames(lambda: scan(ts0, part10), 10)

    # ---------------- 5. the end-to-end path ----------------
    # the bench-like stream, rendered on the card: 60 static frames, flight
    sim = syn.SimConfig(n_frames=E2E_FRAMES, **BENCH_SIM)
    t0 = time.perf_counter()
    tex = syn.smooth_texture(TEXTURE["size"], TEXTURE["size"],
                             seed=TEXTURE["seed"], device=dev)
    etc = TrackerConfig(**TRACKER, K=CAM_K)

    def render(R_c2w, t_c_w):
        return syn.render_plane_view(
            tex, TEXTURE["scale"],
            torch.as_tensor(R_c2w, dtype=torch.float32, device=dev),
            torch.as_tensor(t_c_w, dtype=torch.float32, device=dev),
            CAM_K, etc.height, etc.width).cpu().numpy()

    *e2e_inputs, gt_R, gt_p = bench_stream(
        E2E_FRAMES, lambda t: syn.trajectory_pose_np(sim, t),
        lambda t: syn.imu_np(sim, t), render)
    frame_ts = e2e_inputs[1]
    staged_e = stage_sequence(*e2e_inputs, torch.float32, device=dev)
    stream_s = time.perf_counter() - t0
    fcfg = FilterConfig(**BENCH_FILTER)
    replay = make_e2e_replay(fcfg, etc, R_B2C_DOWN, T_C_B, torch.float32,
                             device=dev)
    ts_e = TrackerState.create(etc, torch.float32, seed=0, device=dev)
    vs_e = VioState.create(fcfg, etc.capacity, torch.float32, device=dev)
    torch.cuda.synchronize()

    # the counted run; K4's inputs are kept per row count q as they pass
    # (stacked update, last-chance update, ZUPT) for the kernel checks
    captured = {}

    def capture(P, K, H, HP=None):
        captured[K.shape[1]] = tuple(x.clone() for x in (P, K, H))
        return cov_update(P, K, H, HP)

    filter_update.cov_update = capture
    dma_gather_tiles.launches = 0
    lk_level_fused.launches = 0
    cov_update.launches = 0
    try:
        t0 = time.perf_counter()
        _, outs = replay(ts_e, vs_e, staged_e)
        torch.cuda.synchronize()
        e2e_first_s = time.perf_counter() - t0
    finally:
        filter_update.cov_update = cov_update
    e2e_launches = {"window_gather": dma_gather_tiles.launches,
                    "lk_level": lk_level_fused.launches,
                    "cov_update": cov_update.launches}

    TE = E2E_FRAMES
    inited = outs["initialized"].cpu().numpy()
    k0 = int(np.argmax(inited)) if inited.any() else None
    n_filter = 0 if k0 is None else TE - 1 - k0
    check(k0 is not None and n_filter >= 200,
          f"static init happened (frame {k0}; JAX: {JAX_E2E['init_frame']}),"
          f" {n_filter} filter frames >= 200")
    check(bool(np.all(inited[k0:])) if k0 is not None else False,
          "initialized stays true after init")
    finite = all(bool(torch.isfinite(outs[f]).all()) for f in ("p", "R", "v"))
    check(finite, "every pose (p, R, v) finite")
    p_est = outs["p"].double().cpu().numpy()
    q_est = quat.from_rotation(outs["R"].double()).cpu().numpy()
    q_gt = quat.from_rotation(torch.as_tensor(gt_R)).numpy()
    try:
        m = ate(frame_ts, p_est, q_est, frame_ts, gt_p, q_gt, "posyaw")
    except ValueError as e:
        m = {"rmse_trans": float("nan"), "rmse_rot_deg": float("nan"),
             "error": str(e)}
    ate_m = m["rmse_trans"]
    ate_limit = JAX_E2E["ate_m"] + ATE_MARGIN_M
    check(bool(np.isfinite(ate_m)) and ate_m <= ate_limit,
          f"ATE {ate_m:.4f} m (posyaw) <= JAX {JAX_E2E['ate_m']:.4f} m + "
          f"{ATE_MARGIN_M} = {ate_limit:.4f} m")
    check(e2e_launches["cov_update"] == 3 * n_filter,
          f"K4 launches {e2e_launches['cov_update']} == 3 x filter frames "
          f"= {3 * n_filter}")
    check(e2e_launches["window_gather"] == 7 * TE
          and e2e_launches["lk_level"] == 4 * TE,
          f"e2e K1 launches {e2e_launches['window_gather']} == 7*T, "
          f"K2 {e2e_launches['lk_level']} == 4*T (T = {TE})")
    n_upd = outs["n_upd"].cpu().numpy()

    # From the states after the frame following init (the last frame that
    # reads the flag): ms/frame over 7 replays of a window of flight, CUDA
    # events (the host sets the pace); no host synchronisation in 20 of
    # those frames; 10 of them profiled. The window, not the whole stream,
    # keeps the script inside its time: a whole replay takes some 50 s.
    e2e_ms, e2e_profile = np.full(1, np.nan), None
    window = range(0 if k0 is None else k0 + 2,
                   E2E_WINDOW + (0 if k0 is None else k0 + 2))
    if k0 is not None and window.stop <= TE:
        (ts_b, vs_b), _ = replay(ts_e, vs_e, staged_e, frames=range(k0 + 2))
        torch.cuda.synchronize()
        ev = []
        for _ in range(7):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            replay(ts_b, vs_b, staged_e, frames=window)
            e1.record()
            ev.append((e0, e1))
        torch.cuda.synchronize()
        e2e_ms = np.asarray([a.elapsed_time(b) / len(window) for a, b in ev])
        check_no_syncs(lambda: replay(ts_b, vs_b, staged_e,
                                      frames=window[:20]),
                       "20 end-to-end frames after init")
        e2e_profile = profile_frames(lambda: replay(
            ts_b, vs_b, staged_e, frames=window[:10]), 10)
    else:
        check(False, f"{E2E_WINDOW} frames after init for the timing, the "
                     "sync check and the profile")
    emit({"e2e": {"frames": TE, "init_frame": k0, "filter_frames": n_filter,
                  "ms_per_frame": float(np.median(e2e_ms)),
                  "min": float(e2e_ms.min()),
                  "p90": float(np.quantile(e2e_ms, 0.9)),
                  "max": float(e2e_ms.max()), "replays": len(e2e_ms),
                  "window": [window.start, window.stop],
                  "whole_stream_ms_per_frame": e2e_first_s * 1e3 / TE,
                  "ate_m": ate_m, "ate_rot_deg": m["rmse_rot_deg"],
                  "jax_ate_m": JAX_E2E["ate_m"],
                  "jax_init_frame": JAX_E2E["init_frame"],
                  "ate_limit_m": ate_limit,
                  "n_upd_total": int(n_upd.sum()),
                  "jax_n_upd_total": JAX_E2E["n_upd_total"],
                  "zupt_frames": int(outs["zupt"].sum()),
                  "launches": e2e_launches, "first_run_s": e2e_first_s,
                  "stream_s": stream_s,
                  "config": "752x480, 3 levels, 200 features; filter D=172, "
                            "sw 20, 30 EKF features, f32"}})

    # ---------------- 6. K4 against its plain version ----------------
    k4_cases = [(f"replay q={q}", *captured[q]) for q in sorted(captured)]
    for dtype in (torch.float32, torch.float64):
        k4_cases.append((f"random {dtype}".replace("torch.", ""),
                         *k4_inputs(172, 444, 3, dtype, dev)))
    check(sorted(captured) == [9, 384, 444],
          f"K4 saw the ZUPT, last-chance and stacked updates: q in "
          f"{sorted(captured)} == [9, 384, 444]")
    k4_err, k4_ratio = {}, 0.0
    for name, P, K, H in k4_cases:
        HP = H @ P
        a = cov_update(P, K, H, HP)
        p = cov_update_plain(P, K, H, HP)
        err = (a - p).abs()
        tol = k4_tolerance(P, K, HP, p)
        ratio = float(torch.where(err == 0, 0.0, err.double() / tol).max())
        k4_err[name] = float(err.max())
        if P.dtype == torch.float32:
            k4_ratio = max(k4_ratio, ratio)
        check(ratio <= 1.0 and bool(torch.equal(a, a.T))
              and bool(torch.isfinite(a).all()),
              f"K4 {name} D={P.shape[0]} q={K.shape[1]}: max |kernel - "
              f"plain| {float(err.max()):.2e}, {ratio:.3f} of the rounding "
              f"bound; exactly symmetric")

    # times at the main path's stacked update, (172, 444) float32
    P, K, H = captured.get(444, k4_inputs(172, 444, 3, torch.float32, dev))
    HP = H @ P
    D, q = K.shape
    k4_ms = time_ms(lambda: cov_update(P, K, H))
    k4_call_ms = time_ms(lambda: cov_update(P, K, H), preload=False)
    k4_kernel_ms = time_ms(lambda: cov_update(P, K, H, HP))
    k4_plain_ms = time_ms(lambda: cov_update_plain(P, K, H))
    k4_plain_call_ms = time_ms(lambda: cov_update_plain(P, K, H),
                               preload=False)
    k4_bytes = 4 * (2 * D * D + 2 * D * q)
    k4_bound, k4_by = bound_ms(k4_bytes, 4 * D * D * q)
    k4_kernel_bound, _ = bound_ms(k4_bytes, 2 * D * D * q)

    for kern in kernels:
        kern["launches_tracker_path"] = kern["launches"]
        kern["launches"] = e2e_launches[kern["name"]]
    kernels.append(
        {"name": "cov_update", "route": "cuda",
         "source": "orcvio_tpu_torch/csrc/cov_update.cu",
         "replaces": "orcvio_tpu/ops/cov_update.py:54",
         "launches": e2e_launches["cov_update"],
         "max_abs_err": max(v for k, v in k4_err.items() if "float64" not in k),
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": k4_plain_ms,
         "shape": f"P ({D},{D}), K ({D},{q}), H ({q},{D}) float32",
         "bytes": k4_bytes, "ops": 4 * D * D * q, "call_ms": k4_call_ms,
         "kernel_ms": k4_kernel_ms, "kernel_bound_ms": k4_kernel_bound,
         "plain_call_ms": k4_plain_call_ms,
         "max_abs_err_by_case": k4_err,
         "max_share_of_rounding_bound_f32": k4_ratio,
         "check": "vs plain on the replay's q=444/384/9 inputs and random "
                  "(172,444) f32/f64: within the rounding bound, exactly "
                  "symmetric"})
    emit({"kernels": kernels})
    emit({"profile": {"tracker": tracker_profile, "e2e": e2e_profile}})

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
