"""Synthetic VIO stream: analytic trajectory, exact IMU, landmark tracks,
textured ground plane.

The port's own copy of ``orcvio_tpu/dataio/synthetic.py``'s host-side
(numpy float64) half: the trajectory, its velocity and IMU in closed form
(``kinematics_np``; the JAX package's ``generate`` takes them by finite
differences, 2.5e-8 away, and its EuRoC writer by autodiff, equal to
float64 rounding), the landmark world and ``generate``'s stacked
FrameInput stream; and the ground-plane renderer, which runs on the
device here. Together they make the benchmark-like
stream of ``scripts/make_bench_seq.py`` (a static start, then flight over
a textured plane) wherever the port runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..filter.pipeline import FrameInput


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_frames: int = 100
    frame_hz: float = 20.0
    imu_hz: float = 200.0
    imu_slab: int = 24
    n_landmarks: int = 300
    max_obs: int = 60  # measurement capacity per frame
    radius: float = 3.0
    omega: float = 0.6  # trajectory angular frequency
    gravity: float = 9.81
    fov_limit: float = 1.2  # normalized-coordinate field of view
    uv_noise: float = 0.002
    gyro_noise: float = 0.004
    acc_noise: float = 0.08
    seed: int = 0
    static_time: float = 0.0  # initial stationary period
    height: float = 0.0  # trajectory altitude offset
    ramp_time: float = 1.0  # C2 smooth ramp-in duration after static_time


def _warp_time_np(sim: SimConfig, t):
    """C2 time warp: 0 until static_time, then a smooth ramp to
    t - static_time."""
    if sim.static_time <= 0:
        return t
    u = np.clip((t - sim.static_time) / sim.ramp_time, 0.0, 1.0)
    w = u * u * u * (10.0 - 15.0 * u + 6.0 * u * u)
    return (t - sim.static_time) * w


def _so3_exp_np(w):
    """Rodrigues, vectorized: w (..., 3) -> (..., 3, 3)."""
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = th < 1e-8
    th_s = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th**2 / 6.0, np.sin(th_s) / th_s)
    b = np.where(small, 0.5 - th**2 / 24.0, (1.0 - np.cos(th_s)) / th_s**2)
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + a * K + b * (K @ K)


def trajectory_pose_np(sim: SimConfig, t):
    """Analytic pose (R body->world, p), vectorized over t: a circle with
    yaw tracking and roll/pitch wobble."""
    t = _warp_time_np(sim, np.asarray(t, np.float64))
    w = sim.omega
    p = np.stack([
        sim.radius * np.sin(w * t),
        sim.radius * (1.0 - np.cos(w * t)),
        sim.height + 0.4 * np.sin(0.7 * w * t) * np.ones_like(t),
    ], axis=-1)
    yaw = w * t
    roll = 0.15 * np.sin(1.3 * w * t)
    pitch = 0.12 * np.sin(0.9 * w * t + 0.5)
    zero = np.zeros_like(yaw)
    R = _so3_exp_np(np.stack([zero, zero, yaw], -1)) @ _so3_exp_np(
        np.stack([roll, pitch, zero], -1))
    return R, p


def _warp_derivs_np(sim: SimConfig, t):
    """(tau, dtau/dt, d2tau/dt2) of the C2 time warp, in closed form."""
    if sim.static_time <= 0:
        return t, np.ones_like(t), np.zeros_like(t)
    s = t - sim.static_time
    u = np.clip(s / sim.ramp_time, 0.0, 1.0)
    du = np.where((u > 0) & (u < 1), 1.0 / sim.ramp_time, 0.0)
    w = u * u * u * (10.0 - 15.0 * u + 6.0 * u * u)
    w1 = 30.0 * u * u * (1.0 - u) ** 2
    w2 = 60.0 * u * (1.0 - u) * (1.0 - 2.0 * u)
    return s * w, w + s * w1 * du, 2.0 * w1 * du + s * w2 * du * du


def _so3_right_jacobian_np(phi):
    """Jr(phi) = I - (1 - cos t)/t^2 hat(phi) + (t - sin t)/t^3 hat(phi)^2."""
    th = np.linalg.norm(phi, axis=-1)[..., None, None]
    small = th < 1e-6
    ts = np.where(small, 1.0, th)
    b = np.where(small, 0.5 - th**2 / 24.0, (1.0 - np.cos(ts)) / ts**2)
    c = np.where(small, 1.0 / 6.0 - th**2 / 120.0, (ts - np.sin(ts)) / ts**3)
    K = np.zeros(phi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -phi[..., 2], phi[..., 1]
    K[..., 1, 0], K[..., 1, 2] = phi[..., 2], -phi[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -phi[..., 1], phi[..., 0]
    return np.broadcast_to(np.eye(3), K.shape) - b * K + c * (K @ K)


def kinematics_np(sim: SimConfig, t):
    """Velocity, gyro and accelerometer of the analytic trajectory by its
    closed-form derivatives (what the JAX package's autodiff
    ``imu_measurements`` gives, to float64 rounding), vectorized over t:
    (v (..., 3), gyro = vee(R^T dR/dt) (..., 3), acc = R^T (d2p/dt2 - g)
    (..., 3))."""
    t = np.asarray(t, np.float64)
    tau, d1, d2 = _warp_derivs_np(sim, t)
    w, r = sim.omega, sim.radius
    wt = w * tau
    dp = np.stack([r * w * np.cos(wt), r * w * np.sin(wt),
                   0.28 * w * np.cos(0.7 * wt)], -1)
    ddp = np.stack([-r * w * w * np.sin(wt), r * w * w * np.cos(wt),
                    -0.196 * w * w * np.sin(0.7 * wt)], -1)
    v = dp * d1[..., None]
    pddot = ddp * (d1 * d1)[..., None] + dp * d2[..., None]
    roll = 0.15 * np.sin(1.3 * wt)
    pitch = 0.12 * np.sin(0.9 * wt + 0.5)
    phi = np.stack([roll, pitch, np.zeros_like(roll)], -1)
    dphi = np.stack([0.15 * 1.3 * w * np.cos(1.3 * wt),
                     0.12 * 0.9 * w * np.cos(0.9 * wt + 0.5),
                     np.zeros_like(roll)], -1) * d1[..., None]
    E = _so3_exp_np(phi)
    # R = Rz(yaw) E(phi): R^T dR/dt = hat(E^T e_z dyaw + Jr(phi) dphi)
    gyro = (E[..., 2, :] * (w * d1)[..., None]
            + np.einsum("...ij,...j->...i", _so3_right_jacobian_np(phi), dphi))
    R, _ = trajectory_pose_np(sim, t)
    g_w = np.array([0.0, 0.0, -sim.gravity])
    acc = np.einsum("...ji,...j->...i", R, pddot - g_w)
    return v, gyro, acc


def initial_state_np(sim: SimConfig):
    """(R0, p0, v0) at t = 0."""
    R0, p0 = trajectory_pose_np(sim, 0.0)
    return R0, p0, kinematics_np(sim, 0.0)[0]


def _landmarks_np(sim: SimConfig):
    """Landmarks scattered around the trajectory's circle, various heights."""
    rng = np.random.default_rng(sim.seed)
    ang = rng.uniform(0, 2 * np.pi, sim.n_landmarks)
    rad = rng.uniform(sim.radius + 1.5, sim.radius + 6.0, sim.n_landmarks)
    z = rng.uniform(-2.0, 3.0, sim.n_landmarks)
    pts = np.stack([rad * np.sin(ang), rad * (1 - np.cos(ang)), z], axis=1)
    # recentre roughly on the circle's centre (0, r)
    pts[:, 1] = rng.uniform(-3.0, sim.radius * 2 + 3.0, sim.n_landmarks)
    pts[:, 0] = rng.uniform(-sim.radius - 4, sim.radius + 4, sim.n_landmarks)
    return pts


def make_landmarks(sim: SimConfig, dtype=torch.float32, device=None):
    """(n_landmarks, 3) world points on `device` (the card unless given)."""
    return torch.as_tensor(_landmarks_np(sim)).to(resolve_device(device),
                                                  dtype)


class SimData(NamedTuple):
    frames: FrameInput  # stacked over time, leading dim n_frames
    gt_R: torch.Tensor  # (T, 3, 3)
    gt_p: torch.Tensor  # (T, 3)
    gt_v: torch.Tensor  # (T, 3)
    landmarks: torch.Tensor


def generate(sim: SimConfig, R_b2c=None, t_c_b=None, dtype=torch.float32,
             device=None) -> SimData:
    """The stacked FrameInput sequence of `sim`: per-frame IMU slabs (t_{k-1},
    t_k] with noise, and noisy normalized observations of the landmarks in
    view. Computed in numpy float64 on the host, in the JAX package's
    generator order; the result is put on `device` (the card unless given)
    once, as `dtype` (integers and masks keep theirs)."""
    device = resolve_device(device)
    R_b2c = np.eye(3) if R_b2c is None else np.asarray(R_b2c, np.float64)
    t_c_b = np.zeros(3) if t_c_b is None else np.asarray(t_c_b, np.float64)
    rng = np.random.default_rng(sim.seed + 1)
    dt_f = 1.0 / sim.frame_hz
    dt_i = 1.0 / sim.imu_hz
    lm = _landmarks_np(sim)
    frame_ts = (np.arange(sim.n_frames) + 1) * dt_f

    # IMU samples per frame: (t_{k-1}, t_k]
    imu_t = frame_ts[:, None] - dt_f + dt_i * (1 + np.arange(sim.imu_slab))
    imu_mask = imu_t <= frame_ts[:, None] + 1e-9
    _, gyro, acc = kinematics_np(sim, imu_t.reshape(-1))
    gyro = gyro.reshape(sim.n_frames, sim.imu_slab, 3)
    acc = acc.reshape(sim.n_frames, sim.imu_slab, 3)
    gyro = gyro + rng.normal(size=gyro.shape) * sim.gyro_noise
    acc = acc + rng.normal(size=acc.shape) * sim.acc_noise
    gt_R, gt_p = trajectory_pose_np(sim, frame_ts)
    gt_v = kinematics_np(sim, frame_ts)[0]

    M = sim.max_obs
    fids = np.full((sim.n_frames, M), -1, np.int32)
    uvs = np.zeros((sim.n_frames, M, 2))
    meas_mask = np.zeros((sim.n_frames, M), bool)
    for k in range(sim.n_frames):
        R_c2w = gt_R[k] @ R_b2c.T
        pc = (lm - (gt_p[k] + gt_R[k] @ t_c_b)) @ R_c2w  # camera frame
        z = np.maximum(pc[:, 2], 1e-6)
        vis = ((pc[:, 2] > 0.5) & (np.abs(pc[:, 0] / z) < sim.fov_limit)
               & (np.abs(pc[:, 1] / z) < sim.fov_limit))
        idx = np.nonzero(vis)[0][:M]
        n = len(idx)
        fids[k, :n] = idx
        uvs[k, :n] = pc[idx, :2] / pc[idx, 2:3] \
            + rng.normal(size=(n, 2)) * sim.uv_noise
        meas_mask[k, :n] = True

    def put(x, dt=dtype):
        return torch.as_tensor(x).to(device=device, dtype=dt)

    frames = FrameInput(
        t=put(frame_ts), imu_t=put(imu_t), imu_gyro=put(gyro),
        imu_acc=put(acc), imu_mask=put(imu_mask, torch.bool),
        fids=put(fids, torch.int32), uvs=put(uvs),
        uv_vels=put(np.zeros_like(uvs)), meas_mask=put(meas_mask, torch.bool))
    return SimData(frames=frames, gt_R=put(gt_R), gt_p=put(gt_p),
                   gt_v=put(gt_v), landmarks=put(lm))


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a linear (triangle-kernel) resize with
    half-pixel centres and normalized weights, as jax.image.resize builds
    them for upsampling."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def smooth_texture(H, W, seed=0, octaves=5, lo=40.0, hi=220.0, device=None):
    """Band-limited random texture with structure at several scales, float32
    (H, W) on `device` (the card unless given): octaves of seeded normal
    noise, each upsampled linearly to (H, W) (in float64) and weighted
    2**octave."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    img = torch.zeros((H, W), dtype=torch.float64, device=device)
    for o in range(octaves):
        h, w = max(H >> (octaves - o), 2), max(W >> (octaves - o), 2)
        layer = torch.as_tensor(rng.normal(size=(h, w))).to(device)
        Ry = torch.as_tensor(_linear_resize_matrix(h, H)).to(device)
        Rx = torch.as_tensor(_linear_resize_matrix(w, W)).to(device)
        img = img + (Ry @ layer @ Rx.T) * (2.0**o)
    img = (img - img.min()) / (img.max() - img.min())
    return (lo + img * (hi - lo)).to(torch.float32)


def bilinear_sample(img, xy):
    """Sample img (H, W) at subpixel xy (..., 2) = (x, y), clamped in bounds."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def render_plane_view(texture, tex_scale, R_c2w, t_c_w, K, height, width):
    """The camera view of a textured z = 0 ground plane, on texture's device.

    texture (Ht, Wt); tex_scale: meters per texel; K = (fx, fy, cx, cy);
    R_c2w (3, 3) and t_c_w (3,) tensors. Pixels whose ray misses the plane
    render as 0."""
    fx, fy, cx, cy = K
    dev = texture.device
    vv, uu = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays_c = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)],
                         dim=-1).to(R_c2w.dtype)
    d = torch.einsum("ij,hwj->hwi", R_c2w, rays_c)
    lam = -t_c_w[2] / torch.where(d[..., 2] < -1e-6, d[..., 2], -1e-6)
    Pxy = t_c_w[None, None, :2] + lam[..., None] * d[..., :2]
    half = torch.tensor([texture.shape[1] / 2.0, texture.shape[0] / 2.0],
                        dtype=torch.float32).to(dev)
    tex_xy = Pxy / tex_scale + half
    vals = bilinear_sample(texture, tex_xy.reshape(-1, 2)).reshape(height, width)
    visible = (d[..., 2] < -1e-3) & (lam > 0.1)
    return torch.where(visible, vals, 0.0)


# the camera extrinsics of the synthetic filter runs (forward-looking
# camera, z along the body's x)
R_B2C_SIM = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_C_B_SIM = np.asarray([0.05, 0.02, 0.0])


def initialized_run(cfg, sim: SimConfig, dtype=torch.float32, device=None):
    """(state, frames, chi2) of a filter run on sim's stream: the frames of
    ``generate`` with the extrinsics R_B2C_SIM, T_C_B_SIM, and a filter
    state at sim's ground truth at t = 0 (the default prior), initialized.
    The set-up of the JAX repository's ``__graft_entry__._build``, on
    `device` (the card unless given)."""
    from ..filter.pipeline import build_chi2_table
    from ..filter.state import FilterState

    device = resolve_device(device)
    frames = generate(sim, R_B2C_SIM, T_C_B_SIM, dtype, device).frames
    st = FilterState.create(cfg, dtype, device=device)
    R0, p0, v0 = (torch.as_tensor(x).to(device, dtype)
                  for x in initial_state_np(sim))
    imu = st.imu.replace(R=R0, p=p0, v=v0)
    st = st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                    R_b2c=torch.as_tensor(R_B2C_SIM).to(device, dtype),
                    t_c_b=torch.as_tensor(T_C_B_SIM).to(device, dtype),
                    initialized=torch.ones((), dtype=torch.bool,
                                           device=device))
    return st, frames, build_chi2_table(cfg, dtype, device)
