"""The filter's per-frame input.

Counterpart of ``orcvio_tpu/filter/pipeline.py``. Only ``FrameInput`` is
ported so far: the front end produces it. The filter step is the next
slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FrameInput(NamedTuple):
    """One camera frame + its IMU slab (pre-binned at dataset load)."""

    t: torch.Tensor  # scalar image timestamp
    imu_t: torch.Tensor  # (S,)
    imu_gyro: torch.Tensor  # (S, 3)
    imu_acc: torch.Tensor  # (S, 3)
    imu_mask: torch.Tensor  # (S,)
    fids: torch.Tensor  # (M,) int32 feature track ids
    uvs: torch.Tensor  # (M, 2) normalized coords
    uv_vels: torch.Tensor  # (M, 2)
    meas_mask: torch.Tensor  # (M,)
