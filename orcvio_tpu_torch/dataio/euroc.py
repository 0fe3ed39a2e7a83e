"""EuRoC MAV dataset reader and per-frame IMU binning (numpy, host-side).

Counterpart of ``orcvio_tpu/dataio/euroc.py`` (reference:
DataReader.hpp:31,67 loadImuFile/loadImageList and dataset_reader.h:50
groundtruth loading): CSV parsing into the statically shaped per-frame IMU
slabs the filter steps over. Images are returned as paths; the port's PNG
codec (``_png.read_gray8``) decodes them.
"""
from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import numpy as np


class EurocSequence(NamedTuple):
    imu_t: np.ndarray  # (N,) seconds
    gyro: np.ndarray  # (N, 3)
    acc: np.ndarray  # (N, 3)
    cam_t: np.ndarray  # (K,) seconds
    image_paths: list
    gt_t: Optional[np.ndarray]  # (G,) seconds
    gt_p: Optional[np.ndarray]  # (G, 3)
    gt_q: Optional[np.ndarray]  # (G, 4) xyzw
    gt_v: Optional[np.ndarray]  # (G, 3)


def load_euroc(root: str) -> EurocSequence:
    """Load a EuRoC sequence directory (the folder containing mav0/)."""
    mav = os.path.join(root, "mav0") \
        if os.path.isdir(os.path.join(root, "mav0")) else root
    imu_csv = np.loadtxt(os.path.join(mav, "imu0", "data.csv"), delimiter=",",
                         skiprows=1)
    imu_t = imu_csv[:, 0] * 1e-9
    gyro = imu_csv[:, 1:4]
    acc = imu_csv[:, 4:7]

    cam_dir = os.path.join(mav, "cam0")
    cam_rows = []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, name = line.split(",")[:2]
            cam_rows.append((int(ts), name))
    cam_t = np.asarray([r[0] for r in cam_rows], dtype=np.float64) * 1e-9
    image_paths = [os.path.join(cam_dir, "data", r[1]) for r in cam_rows]

    gt_t = gt_p = gt_q = gt_v = None
    gt_file = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_file):
        g = np.loadtxt(gt_file, delimiter=",", skiprows=1)
        gt_t = g[:, 0] * 1e-9
        gt_p = g[:, 1:4]
        gt_q = np.concatenate([g[:, 5:8], g[:, 4:5]], axis=1)  # wxyz -> xyzw
        gt_v = g[:, 8:11] if g.shape[1] > 10 else None
    return EurocSequence(imu_t, gyro, acc, cam_t, image_paths, gt_t, gt_p,
                         gt_q, gt_v)


def bin_imu_per_frame(seq: EurocSequence, slab: int, td: float = 0.0,
                      imu_rate_hint: float = 200.0):
    """Assign IMU samples to frames: frame k gets the samples in
    (t_{k-1} + td + h, t_k + td + h], h = 0.5 / imu_rate, the newest
    `slab` of them (batchImuProcessing's time bound, orcvio.cpp:567,686).
    Returns (imu_t, gyro, acc, mask) stacked (K, slab, ...) with exact-zero
    padding."""
    K = len(seq.cam_t)
    out_t = np.zeros((K, slab))
    out_g = np.zeros((K, slab, 3))
    out_a = np.zeros((K, slab, 3))
    out_m = np.zeros((K, slab), bool)
    idx = np.searchsorted(seq.imu_t, seq.cam_t + td + 0.5 / imu_rate_hint,
                          side="right")
    start = dropped = 0
    for k in range(K):
        end = idx[k]
        n = end - start
        sel = slice(start, end)
        if n > slab:
            dropped += n - slab
            sel = slice(end - slab, end)  # keep the newest samples
            n = slab
        out_t[k, :n] = seq.imu_t[sel]
        out_g[k, :n] = seq.gyro[sel]
        out_a[k, :n] = seq.acc[sel]
        out_m[k, :n] = True
        start = end
    if dropped:
        warnings.warn(f"bin_imu_per_frame: dropped {dropped} IMU samples "
                      f"(slab={slab} too small)")
    return out_t, out_g, out_a, out_m


def write_tum(path: str, t, p, q_xyzw):
    """Write a TUM-format trajectory (t x y z qx qy qz qw), the format of the
    reference's stored trajectories (eval_results/euroc_mav/*.txt)."""
    arr = np.column_stack([np.asarray(t), np.asarray(p), np.asarray(q_xyzw)])
    np.savetxt(path, arr, header="timestamp(s) tx ty tz qx qy qz qw",
               fmt="%.9f")


def read_tum(path: str):
    a = np.loadtxt(path, comments="#")
    return a[:, 0], a[:, 1:4], a[:, 4:8]
