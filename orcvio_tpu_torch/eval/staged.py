"""Staged replay: the image and IMU stream resident on the device, one frame
step after another.

Counterpart of ``orcvio_tpu/eval/staged.py``. The JAX package compiles the
whole replay into one ``lax.scan``; here a Python loop runs the frame steps
over device-resident uint8 images, and nothing inside the loop waits for
the device. Only the front end is ported so far (``make_tracker_scan``);
the end-to-end replay with the filter is the next slice.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..filter.pipeline import FrameInput
from ..frontend.tracker import TrackerConfig, TrackerState, process_frame


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
            im = staged.imu_mask[k]
            denom = torch.clamp(torch.sum(im), min=1)
            mean_gyro = torch.sum(
                torch.where(im[:, None], staged.imu_gyro[k], 0.0),
                dim=0) / denom
            ts, tout = process_frame(
                tc, ts, staged.images[k].to(dtype), staged.frame_ts[k],
                mean_gyro, R_b2c, frame_idx=k,
                ransac_gumbel=None if ransac_gumbel is None
                else ransac_gumbel[k])
            outs.append(tout)
        frames = FrameInput(
            t=staged.frame_ts, imu_t=staged.imu_t, imu_gyro=staged.imu_gyro,
            imu_acc=staged.imu_acc, imu_mask=staged.imu_mask,
            fids=torch.stack([o.fids for o in outs]),
            uvs=torch.stack([o.uvs for o in outs]),
            uv_vels=torch.stack([o.uv_vels for o in outs]),
            meas_mask=torch.stack([o.meas_mask for o in outs]),
        )
        return ts, frames

    return scan
