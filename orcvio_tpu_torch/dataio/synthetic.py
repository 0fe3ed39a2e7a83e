"""Synthetic VIO stream: analytic trajectory, exact IMU, textured ground plane.

The port's own copy of what it needs from ``orcvio_tpu/dataio/synthetic.py``:
the host-side (numpy float64) trajectory, velocity and IMU by finite
differences, and the ground-plane renderer, which runs on the device here.
Together they make the benchmark-like stream of
``scripts/make_bench_seq.py`` (a static start, then flight over a textured
plane) wherever the port runs, without dataset bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device


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


# 5-point central-difference stencils: first and second derivative O(h^4)
_FD1 = (np.array([1.0, -8.0, 8.0, -1.0]) / 12.0, np.array([-2, -1, 1, 2]), 1e-4)
_FD2 = (np.array([-1.0, 16.0, -30.0, 16.0, -1.0]) / 12.0,
        np.array([-2, -1, 0, 1, 2]), 1e-3)


def velocity_np(sim: SimConfig, t):
    """dp/dt by finite differences, vectorized over t -> (..., 3)."""
    c, off, h = _FD1
    t = np.asarray(t, np.float64)
    return sum(ci * trajectory_pose_np(sim, t + oi * h)[1]
               for ci, oi in zip(c, off)) / h


def imu_np(sim: SimConfig, t):
    """Exact-trajectory gyro and accelerometer by float64 finite differences:
    gyro = vee(R^T dR/dt), acc = R^T (d2p/dt2 - g)."""
    t = np.asarray(t, np.float64)
    c1, off1, h1 = _FD1
    Rdot = sum(ci * trajectory_pose_np(sim, t + oi * h1)[0]
               for ci, oi in zip(c1, off1)) / h1
    c2, off2, h2 = _FD2
    pddot = sum(ci * trajectory_pose_np(sim, t + oi * h2)[1]
                for ci, oi in zip(c2, off2)) / (h2 * h2)
    R, _ = trajectory_pose_np(sim, t)
    W = np.swapaxes(R, -1, -2) @ Rdot
    gyro = np.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
    g_w = np.array([0.0, 0.0, -sim.gravity])
    acc = np.einsum("...ji,...j->...i", R, pddot - g_w)
    return gyro, acc


def initial_state_np(sim: SimConfig):
    """(R0, p0, v0) at t = 0."""
    R0, p0 = trajectory_pose_np(sim, 0.0)
    return R0, p0, velocity_np(sim, 0.0)


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
