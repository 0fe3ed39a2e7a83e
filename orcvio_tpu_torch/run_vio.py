"""VIO runner: images + IMU -> tracker -> filter -> trajectory.

Counterpart of ``orcvio_tpu/run_vio.py`` (reference: app/orcvioMain.cpp):
a host loop feeds each image to the tracker and its output to the
static-init/filter step, with the dynamic initializer as a fallback while
static init has not fired; it writes a TUM trajectory and, with
groundtruth, reports the ATE. As a command:

    python -m orcvio_tpu_torch.run_vio --euroc DIR --config DIR/config.yaml \\
        [--out traj.txt] [--max-frames N] [--staged] [--device cpu]

Unlike the JAX loop, this one does not wait on the card after
initialization: the IMU slabs are put on the device once, each image is
copied from pinned memory without a wait, and the per-frame outputs stay on
the device until the end (only ``progress_every`` reads them back).
"""
from __future__ import annotations

import argparse
import os
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from . import no_tf32, resolve_device
from .config.core import FilterConfig
from .filter.pipeline import FrameInput, build_chi2_table
from .tree import tree_map
from .frontend.tracker import TrackerConfig, TrackerState, process_frame
from .init.dynamic import flexible_dynamic_attempt, window_tracks
from .vio import VioState, vio_step

DYN_WINDOW = 10  # frames in a dynamic-init attempt
DYN_EVERY = 5  # an attempt on frames k % DYN_EVERY == 0 while not initialized


def _upload(img: np.ndarray, device, dtype):
    """An image on `device`: from pinned memory without a wait on the card."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


def run_image_sequence(
    cfg: FilterConfig,
    tc: TrackerConfig,
    get_image: Callable[[int], np.ndarray],
    frame_ts: np.ndarray,
    imu_t: np.ndarray,
    imu_gyro: np.ndarray,
    imu_acc: np.ndarray,
    imu_mask: np.ndarray,
    R_b2c,
    t_c_b,
    init_filter_state=None,
    dtype=torch.float32,
    progress_every: int = 0,
    device=None,
    ransac_gumbel=None,
    dynamic_gumbel: Optional[Callable[[int, int], torch.Tensor]] = None,
):
    """Host loop over frames. Returns a dict with the trajectory, timing
    and the dynamic-init attempts.

    get_image(k) -> (H, W) array in [0, 255]. IMU arrays are pre-binned
    slabs (K, S, ...). If init_filter_state is given, static init is
    skipped. Every frame re-detects (no frame index is passed to the
    tracker, as in the JAX loop). ransac_gumbel: optional (K, 128, 8, N)
    tracker RANSAC noise; dynamic_gumbel(k, n_rows) -> (256, 8, n_rows)
    noise for the attempt on frame k (tests pass the JAX package's draws);
    without them the draws come from the tracker's generator and from one
    seeded with k.

    Result keys: "t", "p", "R" (numpy), "n_updates", "initialized"
    (per frame, after the frame), "dynamic_attempts" [(k, ok or None)],
    "fps", "final_state".
    """
    device = resolve_device(device)
    no_tf32()
    K = len(frame_ts)

    def put(x, dt=dtype):
        return torch.as_tensor(np.require(x, requirements="W")).to(device, dt)

    R_b2c, t_c_b = put(np.asarray(R_b2c)), put(np.asarray(t_c_b))
    ts_dev, it_dev = put(frame_ts), put(imu_t)
    ig_dev, ia_dev = put(imu_gyro), put(imu_acc)
    im_dev = put(imu_mask, torch.bool)
    g_mean = put(np.stack([imu_gyro[k][imu_mask[k]].mean(axis=0)
                           if imu_mask[k].any() else np.zeros(3)
                           for k in range(K)]))

    ts = TrackerState.create(tc, dtype, device=device)
    vs = VioState.create(cfg, tc.capacity, dtype, device=device)
    fs0 = vs.filter if init_filter_state is None else init_filter_state
    vs = vs.replace(filter=fs0.replace(R_b2c=R_b2c, t_c_b=t_c_b))
    chi2 = build_chi2_table(cfg, dtype, device)

    # FlexibleInitializer fallback (FlexibleInitializer.cpp:10-26): while
    # static init has not fired, try the dynamic initializer on the last
    # DYN_WINDOW frames
    recent = deque(maxlen=DYN_WINDOW)
    attempts = []
    outs, inits = [], []
    t0 = time.perf_counter()
    for k in range(K):
        img = _upload(get_image(k), device, dtype)
        ts, tout = process_frame(
            tc, ts, img, ts_dev[k], g_mean[k], R_b2c,
            ransac_gumbel=None if ransac_gumbel is None else ransac_gumbel[k])
        frame = FrameInput(t=ts_dev[k], imu_t=it_dev[k], imu_gyro=ig_dev[k],
                           imu_acc=ia_dev[k], imu_mask=im_dev[k],
                           fids=tout.fids, uvs=tout.uvs,
                           uv_vels=tout.uv_vels, meas_mask=tout.meas_mask)
        if not vs.host_initialized and bool(vs.filter.initialized):
            vs = vs.replace(host_initialized=True)
        if not vs.host_initialized:
            recent.append(frame)
            if len(recent) == DYN_WINDOW and k % DYN_EVERY == 0:
                window = list(recent)
                gumbel = generator = None
                if dynamic_gumbel is not None:
                    gumbel = dynamic_gumbel(
                        k, window_tracks(window)[0].shape[0]).to(device)
                else:
                    generator = torch.Generator(device=device).manual_seed(k)
                res = flexible_dynamic_attempt(cfg, window, R_b2c, t_c_b,
                                               gumbel=gumbel,
                                               generator=generator)
                ok = None if res is None else bool(res.ok)
                attempts.append((k, ok))
                if ok:
                    imu0 = tree_map(lambda x: x.to(dtype), res.imu)
                    fs = vs.filter
                    # the device flag and its host copy are set together
                    vs = vs.replace(filter=fs.replace(
                        imu=imu0, imu_old=imu0, imu_fej_now=imu0,
                        imu_fej_old=imu0, t=ts_dev[k],
                        initialized=torch.ones_like(fs.initialized)),
                        host_initialized=True)
                    print(f"[init] dynamic initialization at frame {k} "
                          f"(scale {float(res.scale):.3f})")
        vs, fout = vio_step(cfg, vs, frame, chi2)
        outs.append(fout)
        inits.append(vs.filter.initialized)
        if progress_every and (k + 1) % progress_every == 0:
            print(f"frame {k + 1}/{K} "
                  f"p={np.round(fout.p.cpu().numpy(), 2)} "
                  f"upd={int(fout.n_update_features)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return {
        "t": np.asarray(frame_ts, np.float64),
        "p": torch.stack([o.p for o in outs]).cpu().numpy(),
        "R": torch.stack([o.R for o in outs]).cpu().numpy(),
        "n_updates": torch.stack([o.n_update_features
                                  for o in outs]).cpu().numpy(),
        "initialized": torch.stack(inits).cpu().numpy(),
        "dynamic_attempts": attempts,
        "fps": K / wall,
        "final_state": vs,
    }


def open_sequence(root: str, slab: int, td: float):
    """The sequence's reader: the native loader where it builds, else the
    Python reader with the port's PNG decoder. Returns (name, seq, (imu_t,
    gyro, acc, mask) slabs, get_image); seq has imu_t, gyro, acc, cam_t,
    gt_t, gt_p, gt_q."""
    from .dataio._png import read_gray8
    from .dataio.euroc import bin_imu_per_frame, load_euroc
    from .dataio.native import NativeEurocLoader

    try:
        nat = NativeEurocLoader(root)
    except Exception as e:  # no g++ or libpng: the Python reader
        seq = load_euroc(root)
        return (f"python (native unavailable: {str(e).splitlines()[0]})", seq,
                bin_imu_per_frame(seq, slab, td),
                lambda k: read_gray8(seq.image_paths[k]))
    return "native", nat, nat.bin_imu(slab, td), nat.get_image


def main(argv=None):
    """The command; returns a summary dict (reader, fps, the trajectory
    result, ATE under "se3" and "posyaw" where groundtruth exists)."""
    from .config.yaml_io import load_initial_state, load_reference_yaml
    from .dataio.euroc import write_tum
    from .eval.trajectory import ate
    from .filter.state import FilterState
    from .math import quat

    ap = argparse.ArgumentParser()
    ap.add_argument("--euroc", required=True,
                    help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--config", default=None,
                    help="reference config YAML (default: EUROC/config.yaml)")
    ap.add_argument("--out", default="traj_estimate.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--imu-slab", type=int, default=16)
    ap.add_argument("--staged", action="store_true",
                    help="stage the whole image stream on the device and run "
                    "the staged replay (requires static init, no dynamic "
                    "fallback)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                    "the plain versions)")
    args = ap.parse_args(argv)
    config = args.config or os.path.join(args.euroc, "config.yaml")
    device = resolve_device(args.device)
    dtype = torch.float32

    cfg, cam, fe = load_reference_yaml(config)
    cfg = FilterConfig(**{**cfg.__dict__, "imu_slab": args.imu_slab})
    reader, seq, (imu_t, gyro, acc, mask), get_image = open_sequence(
        args.euroc, args.imu_slab, cfg.td)
    print(f"reader: {reader}")

    # Rebase times to the sequence start: absolute EuRoC epochs (~1.4e9 s)
    # have a 128 s ulp in float32. The filter only uses time differences.
    t_origin = float(seq.cam_t[0]) - 1.0
    seq_cam_t = seq.cam_t - t_origin
    imu_t = imu_t - t_origin * (imu_t != 0.0)  # padded slab entries stay 0
    gt_t_rel = None if seq.gt_t is None else seq.gt_t - t_origin

    K = len(seq.cam_t) if not args.max_frames \
        else min(args.max_frames, len(seq.cam_t))
    frame_hz = 1.0 / max(float(np.median(np.diff(seq_cam_t[:min(K, 50)]))),
                         1e-3)
    tc = TrackerConfig(
        height=cam.height, width=cam.width,
        pyramid_levels=fe.pyramid_levels + 1,
        capacity=fe.max_features_num,
        min_distance=float(fe.min_distance),
        equalize=fe.flag_equalize,
        K=(cam.fx, cam.fy, cam.cx, cam.cy),
        dist_model=cam.distortion_model,
        dist_coeffs=tuple(cam.dist_coeffs),
        # re-detect at the reference's pub_frequency cadence
        detect_every=max(1, round(frame_hz / fe.pub_frequency)),
    )
    R_b2c, t_c_b = np.asarray(cam.R_b2c), np.asarray(cam.t_c_b)
    # GT initial state from the config (initial_use_gt, orcvio.cpp:123)
    init_fs = None
    gt0 = load_initial_state(config)
    if gt0 is not None:
        st0 = FilterState.create(cfg, dtype, device)

        def put(key):
            return torch.as_tensor(gt0[key]).to(device, dtype)

        imu0 = st0.imu.replace(R=put("R"), v=put("v"), p=put("p"),
                               bg=put("bg"), ba=put("ba"))
        init_fs = st0.replace(
            t=torch.as_tensor(gt0["t"]).to(device, dtype), imu=imu0,
            imu_fej_now=imu0, imu_old=imu0,
            R_b2c=torch.as_tensor(R_b2c).to(device, dtype),
            t_c_b=torch.as_tensor(t_c_b).to(device, dtype),
            initialized=torch.ones_like(st0.initialized))
        print("initialized from GT state in config")

    if args.staged:
        from .eval.staged import (load_bench_images, make_e2e_replay,
                                  stage_sequence)

        if reader == "native":
            images = np.stack([np.asarray(get_image(k), np.uint8)
                               for k in range(K)])
        else:
            images = load_bench_images(seq.image_paths, tc.height, tc.width,
                                       limit=K)
        staged = stage_sequence(images, seq_cam_t[:K], imu_t[:K], gyro[:K],
                                acc[:K], mask[:K], dtype, device=device)
        replay = make_e2e_replay(cfg, tc, R_b2c, t_c_b, dtype, device=device)
        ts0 = TrackerState.create(tc, dtype, device=device)
        vs0 = VioState.create(cfg, tc.capacity, dtype, device=device)
        if init_fs is not None:
            vs0 = vs0.replace(filter=init_fs)
        t0 = time.perf_counter()
        _, outs = replay(ts0, vs0, staged)
        res = {"t": np.asarray(seq_cam_t[:K], np.float64),
               "p": outs["p"].cpu().numpy(), "R": outs["R"].cpu().numpy(),
               "n_updates": outs["n_upd"].cpu().numpy(),
               "initialized": outs["initialized"].cpu().numpy(),
               "dynamic_attempts": []}
        res["fps"] = K / (time.perf_counter() - t0)
    else:
        res = run_image_sequence(
            cfg, tc, get_image, seq_cam_t[:K], imu_t[:K], gyro[:K], acc[:K],
            mask[:K], R_b2c, t_c_b, init_filter_state=init_fs, dtype=dtype,
            progress_every=100, device=device)
    q = quat.from_rotation(torch.as_tensor(res["R"], dtype=torch.float64))
    q = q.numpy()
    write_tum(args.out, res["t"] + t_origin, res["p"], q)
    print(f"fps={res['fps']:.1f}, wrote {args.out}")
    summary = {"reader": reader, "fps": res["fps"], "frames": K,
               "result": res, "ate": {}}
    if gt_t_rel is not None:
        for alignment in ("se3", "posyaw"):
            try:
                m = ate(res["t"], res["p"], q, gt_t_rel, seq.gt_p, seq.gt_q,
                        alignment=alignment)
            except ValueError as e:
                print(f"ATE skipped: {e}")
                break
            summary["ate"][alignment] = m
            print(f"ATE {alignment}: {m['rmse_trans']:.3f} m, "
                  f"{m['rmse_rot_deg']:.2f} deg ({m['n_matched']} matched)")
    return summary


if __name__ == "__main__":
    main()
