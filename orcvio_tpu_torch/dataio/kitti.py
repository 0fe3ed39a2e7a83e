"""KITTI dataset readers: odometry sequences and raw-drive OXTS.

Counterpart of ``orcvio_tpu/dataio/kitti.py``, numpy on the host (the
reference's KITTI configs and evaluation protocol
(config/kitti_odom.yaml, kitti_raw.yaml; eval_results/kitti_eval/eval_info.md;
python_scripts/object_map_eval/kitti_sem_data_loader.py): parsing into
the same arrays the EuRoC reader gives, so the runner works unchanged.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class KittiOdometrySeq(NamedTuple):
    times: np.ndarray  # (K,) seconds
    image_paths: list  # left grayscale (image_0)
    K: np.ndarray  # (3, 3) intrinsics from P0
    gt_T: Optional[np.ndarray]  # (K, 4, 4) cam0 poses (odometry gt), or None


def load_kitti_odometry(seq_dir: str, poses_file: Optional[str] = None) -> KittiOdometrySeq:
    """Load a KITTI odometry sequence dir (contains image_0/, times.txt, calib.txt)."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    img_dir = os.path.join(seq_dir, "image_0")
    image_paths = [
        os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir)) if f.endswith(".png")
    ]
    K = np.eye(3)
    with open(os.path.join(seq_dir, "calib.txt")) as f:
        for line in f:
            if line.startswith("P0:"):
                P0 = np.asarray([float(v) for v in line.split()[1:]]).reshape(3, 4)
                K = P0[:, :3]
    gt_T = None
    if poses_file and os.path.exists(poses_file):
        raw = np.loadtxt(poses_file)
        gt_T = np.tile(np.eye(4), (len(raw), 1, 1))
        gt_T[:, :3, :] = raw.reshape(-1, 3, 4)
    return KittiOdometrySeq(times=times, image_paths=image_paths, K=K, gt_T=gt_T)


class KittiOxts(NamedTuple):
    t: np.ndarray  # (N,) seconds
    gyro: np.ndarray  # (N, 3) body rates (wf, wl, wu)
    acc: np.ndarray  # (N, 3) body accelerations (af, al, au)
    lat_lon_alt: np.ndarray  # (N, 3)
    rpy: np.ndarray  # (N, 3)


def _parse_kitti_timestamp(line: str) -> float:
    # "2011-09-26 13:02:25.964002455"
    from datetime import datetime

    date, clock = line.strip().split(" ")
    main, frac = clock.split(".")
    dt = datetime.strptime(f"{date} {main}", "%Y-%m-%d %H:%M:%S")
    return dt.timestamp() + float("0." + frac)


def load_kitti_oxts(drive_dir: str) -> KittiOxts:
    """Load raw-drive OXTS (IMU/GPS) from <drive>/oxts/.

    OXTS dataformat (dataformat.txt): fields 11-13 = af, al, au (m/s^2, body),
    fields 17-19 = wf, wl, wu (rad/s, body).
    """
    oxts = os.path.join(drive_dir, "oxts")
    with open(os.path.join(oxts, "timestamps.txt")) as f:
        t = np.asarray([_parse_kitti_timestamp(l) for l in f if l.strip()])
    data_dir = os.path.join(oxts, "data")
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".txt"))
    rows = np.stack([np.loadtxt(os.path.join(data_dir, f)) for f in files])
    return KittiOxts(
        t=t - t[0],
        gyro=rows[:, 17:20],
        acc=rows[:, 11:14],
        lat_lon_alt=rows[:, 0:3],
        rpy=rows[:, 3:6],
    )


def kitti_times_to_frame_stream(times, imu_t, gyro, acc, slab: int, td: float = 0.0,
                                imu_rate_hint: float = 100.0):
    """Bin OXTS samples per camera frame, same contract as euroc.bin_imu_per_frame."""
    from .euroc import EurocSequence, bin_imu_per_frame

    seq = EurocSequence(
        imu_t=np.asarray(imu_t), gyro=np.asarray(gyro), acc=np.asarray(acc),
        cam_t=np.asarray(times), image_paths=[], gt_t=None, gt_p=None, gt_q=None, gt_v=None,
    )
    return bin_imu_per_frame(seq, slab, td, imu_rate_hint)
