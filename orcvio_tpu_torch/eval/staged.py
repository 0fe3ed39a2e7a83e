"""Staged replay: the image and IMU stream resident on the device, one frame
step after another.

Counterpart of ``orcvio_tpu/eval/staged.py``. The JAX package compiles the
whole replay into one ``lax.scan``; here a Python loop runs the frame steps
over device-resident uint8 images, and nothing inside the loop waits for
the device. ``make_e2e_replay`` runs the tracker and then ``vio_step``
(static init, then the filter) per frame; ``make_tracker_scan`` runs the
front end alone. After initialization the loop reads nothing back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..config.core import FilterConfig, require_supported
from ..filter.pipeline import FrameInput, build_chi2_table
from ..frontend.tracker import TrackerConfig, TrackerState, process_frame
from ..vio import VioState, vio_step


class StagedInputs(NamedTuple):
    images: torch.Tensor  # (T, H, W) uint8, device-resident
    frame_ts: torch.Tensor  # (T,)
    imu_t: torch.Tensor  # (T, S)
    imu_gyro: torch.Tensor  # (T, S, 3)
    imu_acc: torch.Tensor  # (T, S, 3)
    imu_mask: torch.Tensor  # (T, S) bool


def stage_sequence(images_u8: np.ndarray, frame_ts, imu_t, imu_gyro, imu_acc,
                   imu_mask, dtype=torch.float32, device=None) -> StagedInputs:
    """Upload the sequence once (images stay uint8 to halve device traffic)."""
    device = resolve_device(device)

    def put(x, dt):
        x = np.require(x, requirements="W")  # torch wants writable arrays
        return torch.as_tensor(x).to(device=device, dtype=dt)

    return StagedInputs(
        images=put(images_u8, torch.uint8),
        frame_ts=put(frame_ts, dtype),
        imu_t=put(imu_t, dtype),
        imu_gyro=put(imu_gyro, dtype),
        imu_acc=put(imu_acc, dtype),
        imu_mask=put(imu_mask, torch.bool),
    )


def _track(tc: TrackerConfig, ts: TrackerState, staged: StagedInputs, k: int,
           R_b2c, dtype, ransac_gumbel=None):
    """Frame k through the front end: (tracker state, FrameInput)."""
    im = staged.imu_mask[k]
    denom = torch.clamp(torch.sum(im), min=1)
    mean_gyro = torch.sum(torch.where(im[:, None], staged.imu_gyro[k], 0.0),
                          dim=0) / denom
    ts, tout = process_frame(
        tc, ts, staged.images[k].to(dtype), staged.frame_ts[k], mean_gyro,
        R_b2c, frame_idx=k,
        ransac_gumbel=None if ransac_gumbel is None else ransac_gumbel[k])
    frame = FrameInput(
        t=staged.frame_ts[k], imu_t=staged.imu_t[k],
        imu_gyro=staged.imu_gyro[k], imu_acc=staged.imu_acc[k],
        imu_mask=staged.imu_mask[k], fids=tout.fids, uvs=tout.uvs,
        uv_vels=tout.uv_vels, meas_mask=tout.meas_mask)
    return ts, frame


def make_e2e_replay(cfg: FilterConfig, tc: TrackerConfig, R_b2c, t_c_b,
                    dtype=torch.float32, device=None):
    """Build replay(tracker_state, vio_state, staged, ransac_gumbel=None,
    frames=None) -> ((tracker_state, vio_state), outs).

    outs: dict of per-frame stacked "p", "R", "v", "n_upd", "zupt" (as
    the JAX package's) and "initialized" (the filter's flag after the
    frame: true from the frame static init ends on).
    frames: a range of frame indices to run (default: all); the frame index
    sets the detection cadence, as in the JAX package's scan. ransac_gumbel:
    optional per-frame (T, 128, 8, N) RANSAC noise (tests pass the JAX
    package's draws). Timestamps are used as given; a caller with absolute
    epochs rebases them first, since float32 cannot hold them.
    """
    require_supported(cfg)
    device = resolve_device(device)
    no_tf32()
    chi2 = build_chi2_table(cfg, dtype, device)
    R_b2c = torch.as_tensor(np.asarray(R_b2c)).to(device=device, dtype=dtype)
    t_c_b = torch.as_tensor(np.asarray(t_c_b)).to(device=device, dtype=dtype)

    def replay(tracker_state: TrackerState, vio_state: VioState,
               staged: StagedInputs, ransac_gumbel=None, frames=None):
        # pin the camera-imu extrinsics into the filter state, so a caller
        # cannot run with the default identity extrinsics by accident
        vs = vio_state.replace(filter=vio_state.filter.replace(
            R_b2c=R_b2c, t_c_b=t_c_b))
        ts = tracker_state
        outs, inits = [], []
        for k in (range(staged.images.shape[0]) if frames is None else frames):
            ts, frame = _track(tc, ts, staged, k, R_b2c, dtype, ransac_gumbel)
            vs, fout = vio_step(cfg, vs, frame, chi2)
            outs.append(fout)
            inits.append(vs.filter.initialized)
        stacked = {name: torch.stack([getattr(o, field) for o in outs])
                   for name, field in (("p", "p"), ("R", "R"), ("v", "v"),
                                       ("n_upd", "n_update_features"),
                                       ("zupt", "zupt"))}
        stacked["initialized"] = torch.stack(inits)
        return (ts, vs), stacked

    return replay


def make_tracker_scan(tc: TrackerConfig, R_b2c, dtype=torch.float32,
                      device=None):
    """Build scan(tracker_state, staged, ransac_gumbel=None) ->
    (final state, FrameInput of (T, ...) tensors).

    Runs only the front end over the staged image stream. ransac_gumbel:
    optional per-frame (T, 128, 8, N) Gumbel noise for the RANSAC draws
    (tests pass the JAX package's exact draws).
    """
    device = resolve_device(device)
    R_b2c = torch.as_tensor(np.asarray(R_b2c)).to(device=device, dtype=dtype)

    def scan(tracker_state: TrackerState, staged: StagedInputs,
             ransac_gumbel=None):
        ts = tracker_state
        outs = []
        for k in range(staged.images.shape[0]):
            ts, frame = _track(tc, ts, staged, k, R_b2c, dtype, ransac_gumbel)
            outs.append(frame)
        return ts, FrameInput(*(torch.stack(x) for x in zip(*outs)))

    return scan


def load_bench_images(image_paths, height, width, limit=None) -> np.ndarray:
    """(K, height, width) uint8 frames decoded from PNG paths."""
    from ..dataio._png import read_gray8

    paths = image_paths if limit is None else image_paths[:limit]
    out = np.empty((len(paths), height, width), np.uint8)
    for i, p in enumerate(paths):
        out[i] = read_gray8(p)
    return out
