"""Write a synthetic sequence to disk in EuRoC MAV dataset format.

Counterpart of ``orcvio_tpu/dataio/euroc_writer.py``: frames rendered over
a textured ground plane along the analytic trajectory, written in the
on-disk format the reference's DataReader parses (DataReader.hpp:31,67: ns
timestamps, a header line, CRLF, no trailing newline) with EuRoC-style
17-column groundtruth (dataset_reader.h:50), and a ``config.yaml`` in the
reference's schema. ``make_stream`` makes the sequence in memory: it
renders on the device with ``synthetic.render_plane_view`` in float64
geometry, takes the velocity and IMU from the trajectory's closed-form
derivatives (``synthetic.kinematics_np``, equal to the JAX package's
autodiff to float64 rounding), and one numpy generator adds the IMU noise
first, then each frame's image noise, as the JAX package's writer does.
``write_stream`` writes it, the PNGs with the port's own codec.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..math import quat as quat_ops
from ._png import write_gray8
from .synthetic import (SimConfig, kinematics_np, render_plane_view,
                        smooth_texture, trajectory_pose_np)


@dataclasses.dataclass(frozen=True)
class CameraModel:
    width: int = 752
    height: int = 480
    fx: float = 458.0
    fy: float = 458.0
    cx: float = 376.0
    cy: float = 240.0

    @property
    def K(self):
        return (self.fx, self.fy, self.cx, self.cy)


# camera looking straight down at the z=0 plane (body z up):
# cam x = body x, cam y = -body y, cam z = -body z
R_B2C_DOWN = np.asarray([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])


@dataclasses.dataclass(frozen=True)
class WriterConfig:
    cam: CameraModel = CameraModel()
    t_c_b: tuple = (0.03, 0.01, 0.0)  # camera position in body frame
    tex_size: int = 2048
    tex_scale: float = 0.012  # meters per texel (~24.6 m square world)
    tex_seed: int = 4
    image_noise: float = 1.5  # grayscale std added per frame
    gyro_bias: tuple = (0.002, -0.0015, 0.001)  # rad/s constant bias
    acc_bias: tuple = (0.02, -0.015, 0.025)  # m/s^2 constant bias
    t0_ns: int = 1_400_000_000_000_000_000  # EuRoC-era epoch base


def _write_rows(path, rows, header):
    """CRLF join with header and NO trailing newline (DataReader reads a
    bogus zero-timestamp row if the file ends with a newline)."""
    with open(path, "w", newline="") as f:
        f.write("\r\n".join([header] + rows))


class EurocStream(NamedTuple):
    """A written sequence's content in memory (times in seconds from the
    sequence's start)."""
    frame_ts: np.ndarray  # (n,)
    imu_ts: np.ndarray  # (N,)
    gyro: np.ndarray  # (N, 3) with noise and bias
    acc: np.ndarray  # (N, 3) with noise and bias
    gt_R: np.ndarray  # (n, 3, 3) body to world
    gt_p: np.ndarray  # (n, 3)
    gt_v: np.ndarray  # (n, 3)
    images: np.ndarray  # (n, height, width) uint8
    render_s: float  # seconds spent rendering


def make_stream(sim: SimConfig, wc: WriterConfig = WriterConfig(),
                device=None) -> EurocStream:
    """What write_euroc_dataset writes, in memory, rendering on `device`
    (the card unless given): the ground truth at the frame times, the
    noisy IMU at imu_hz and the noisy 8-bit frames. One numpy generator
    adds the IMU noise first, then each frame's image noise."""
    device = resolve_device(device)
    dt_f = 1.0 / sim.frame_hz
    dt_i = 1.0 / sim.imu_hz
    n = sim.n_frames
    frame_ts = (np.arange(n) + 1) * dt_f
    imu_ts = dt_i * (1 + np.arange(int(round((n + 1) * dt_f * sim.imu_hz))))
    gt_R, gt_p = trajectory_pose_np(sim, frame_ts)
    gt_v = kinematics_np(sim, frame_ts)[0]
    _, gyro, acc = kinematics_np(sim, imu_ts)

    rng = np.random.default_rng(sim.seed + 100)
    gyro = gyro + rng.normal(size=gyro.shape) * sim.gyro_noise \
        + np.asarray(wc.gyro_bias)
    acc = acc + rng.normal(size=acc.shape) * sim.acc_noise \
        + np.asarray(wc.acc_bias)

    tex = smooth_texture(wc.tex_size, wc.tex_size, seed=wc.tex_seed,
                         device=device)
    R_c2w = torch.as_tensor(gt_R @ R_B2C_DOWN.T).to(device)
    t_cw = torch.as_tensor(gt_p + gt_R @ np.asarray(wc.t_c_b)).to(device)
    images = np.empty((n, wc.cam.height, wc.cam.width), np.uint8)
    render_s = 0.0
    for k in range(n):
        t0 = time.perf_counter()
        img = render_plane_view(tex, wc.tex_scale, R_c2w[k], t_cw[k],
                                wc.cam.K, wc.cam.height,
                                wc.cam.width).cpu().numpy()
        render_s += time.perf_counter() - t0
        img = img + rng.normal(size=img.shape) * wc.image_noise
        images[k] = np.clip(img, 0, 255).astype(np.uint8)
    return EurocStream(frame_ts, imu_ts, gyro, acc, gt_R, gt_p, gt_v, images,
                       render_s)


def write_stream(out_dir: str, stream: EurocStream,
                 wc: WriterConfig = WriterConfig()) -> dict:
    """Write a stream as mav0/{cam0,imu0,state_groundtruth_estimate0}.

    Returns a dict with the mav0 path, the frames' ns timestamps and the
    seconds spent encoding PNGs ("encode_s")."""
    mav = os.path.join(out_dir, "mav0")
    cam_dir = os.path.join(mav, "cam0", "data")
    imu_dir = os.path.join(mav, "imu0")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    for d in (cam_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)
    gyro, acc = stream.gyro, stream.acc

    # --- imu0/data.csv: int64 BEFORE adding the epoch (float64 loses ns
    # precision at 1.4e18) ---
    ns = wc.t0_ns + np.round(stream.imu_ts * 1e9).astype(np.int64)
    rows = [f"{ns[i]},{gyro[i,0]:.9f},{gyro[i,1]:.9f},{gyro[i,2]:.9f},"
            f"{acc[i,0]:.9f},{acc[i,1]:.9f},{acc[i,2]:.9f}"
            for i in range(len(ns))]
    _write_rows(os.path.join(imu_dir, "data.csv"), rows,
                "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]")

    # --- cam0 frames ---
    frame_ns = wc.t0_ns + np.round(stream.frame_ts * 1e9).astype(np.int64)
    img_rows = []
    t0 = time.perf_counter()
    for k, img in enumerate(stream.images):
        name = f"{frame_ns[k]}.png"
        write_gray8(os.path.join(cam_dir, name), img)
        img_rows.append(f"{frame_ns[k]},{name}")
    encode_s = time.perf_counter() - t0
    _write_rows(os.path.join(mav, "cam0", "data.csv"), img_rows,
                "#timestamp [ns],filename")

    # --- groundtruth (EuRoC 17-column state format, w first) ---
    q_wxyz = quat_ops.from_rotation(torch.as_tensor(stream.gt_R)).numpy()[
        :, [3, 0, 1, 2]]
    gb, ab = wc.gyro_bias, wc.acc_bias
    gt_rows = []
    for k in range(len(frame_ns)):
        p, q, v = stream.gt_p[k], q_wxyz[k], stream.gt_v[k]
        gt_rows.append(
            f"{frame_ns[k]},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
            f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f},"
            f"{v[0]:.9f},{v[1]:.9f},{v[2]:.9f},"
            f"{gb[0]},{gb[1]},{gb[2]},{ab[0]},{ab[1]},{ab[2]}")
    _write_rows(os.path.join(gt_dir, "data.csv"), gt_rows,
                "#timestamp,p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
                "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z [],"
                "v_RS_R_x [m s^-1],v_RS_R_y [m s^-1],v_RS_R_z [m s^-1],"
                "b_w_RS_S_x [rad s^-1],b_w_RS_S_y [rad s^-1],"
                "b_w_RS_S_z [rad s^-1],b_a_RS_S_x [m s^-2],"
                "b_a_RS_S_y [m s^-2],b_a_RS_S_z [m s^-2]")
    return {"mav0": mav, "frame_ns": frame_ns, "encode_s": encode_s}


def write_euroc_dataset(out_dir: str, sim: SimConfig,
                        wc: WriterConfig = WriterConfig(),
                        device=None) -> dict:
    """Generate (make_stream, on `device`: the card unless given) and
    write (write_stream) mav0/{cam0,imu0,state_groundtruth_estimate0}.

    Returns a dict with the ground-truth arrays, file paths and the
    seconds spent rendering and encoding ("render_s", "encode_s")."""
    st = make_stream(sim, wc, device)
    return {**write_stream(out_dir, st, wc), "frame_ts": st.frame_ts,
            "gt_R": st.gt_R, "gt_p": st.gt_p, "gt_v": st.gt_v,
            "render_s": st.render_s}


def write_reference_config(path: str, sim: SimConfig,
                           wc: WriterConfig = WriterConfig(),
                           output_dir: str = "/tmp/refbench_cache/",
                           **overrides) -> str:
    """Emit a config YAML in the reference's schema (config/euroc.yaml keys,
    orcvio.cpp:62-415 loadParameters) describing the synthetic camera: zero
    distortion, the writer's intrinsics and extrinsics, EuRoC noise and
    filter settings. The text is the JAX package's, byte for byte;
    `output_dir` is only written into it (the reference's output folder),
    not created."""
    cam = wc.cam
    # T_cam_imu: maps imu/body-frame points into the camera frame
    T = np.eye(4)
    T[:3, :3] = R_B2C_DOWN
    T[:3, 3] = -R_B2C_DOWN @ np.asarray(wc.t_c_b)
    rows = ",\n     ".join(
        ", ".join(f"{T[i, j]:.15f}" for j in range(4)) for i in range(4))
    params = dict(
        if_FEJ=0, estimate_extrin=0, estimate_td=0, calib_imu_instrinsic=0,
        pyramid_levels=2, patch_size=21, fast_threshold=30, max_iteration=30,
        track_precision=0.01, ransac_threshold=1, max_features_num=200,
        min_distance=20, flag_equalize=1, pub_frequency=10,
        sw_size=20,
        position_std_threshold=8.0, rotation_threshold=0.2618,
        translation_threshold=0.4, tracking_rate_threshold=0.5,
        least_observation_number=3, max_track_len=6,
        feature_translation_threshold=-1.0,
        noise_gyro=0.004, noise_acc=0.08, noise_gyro_bias=2e-6,
        noise_acc_bias=4e-5, noise_feature=0.008,
        initial_covariance_orientation=4e-4, initial_covariance_velocity=0.25,
        initial_covariance_position=1.0, initial_covariance_gyro_bias=4e-4,
        initial_covariance_acc_bias=0.01,
        initial_covariance_extrin_rot=3.0462e-8,
        initial_covariance_extrin_trans=9e-8,
        reset_fej_threshold=10.11,
        if_ZUPT_valid=1, if_use_feature_zupt_flag=1, zupt_max_feature_dis=2e-3,
        zupt_noise_v=1e-2, zupt_noise_p=1e-2, zupt_noise_q=3.4e-2,
        static_duration=1.0,
        imu_rate=200, img_rate=int(sim.frame_hz),
        max_features_in_one_grid=1, aug_grid_rows=5, aug_grid_cols=6,
        feature_idp_dim=1,
        use_schmidt=0, use_left_perturbation_flag=0,
        use_closed_form_cov_prop_flag=1, use_larvio_flag=1,
        chi_square_threshold_feat=0.95, feature_cost_threshold=4.7673e-04,
        init_final_dist_threshold=1e2, discard_large_update_flag=0,
        use_object_residual_update_cam_pose_flag=0, prediction_only_flag=0,
        initial_use_gt=0,
    )
    params.update(overrides)
    lines = ["%YAML:1.0", "", f'output_dir: "{output_dir}"', ""]
    lines += [f"{k}: {v}" for k, v in params.items()]
    lines += [
        "",
        'camera_model: "pinhole"',
        'distortion_model: "radtan"',
        f"resolution_width: {cam.width}",
        f"resolution_height: {cam.height}",
        "intrinsics:",
        f"   fx: {cam.fx}",
        f"   fy: {cam.fy}",
        f"   cx: {cam.cx}",
        f"   cy: {cam.cy}",
        "distortion_coeffs:",
        "   k1: 0.0",
        "   k2: 0.0",
        "   p1: 0.0",
        "   p2: 0.0",
        "T_cam_imu: !!opencv-matrix",
        "   rows: 4",
        "   cols: 4",
        "   dt: d",
        "   data:",
        f"    [{rows}]",
        "td: 0.0",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path
