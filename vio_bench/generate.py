"""The benchmark's one traffic generator: every mix is a data file under
``vio_bench/traffic/`` whose "generator" key names one of the kinds below,
and whose other keys are that kind's parameters.

- ``synthetic_tracks``: feature messages of a landmark world seen along
  an analytic trajectory (orcvio_tpu_torch/dataio/synthetic.py:generate),
  one sequence per row: the noise-free tracks once, then each row's
  measurement and IMU noise drawn on the device from the run's seed.

The geometry below is frozen from orcvio_tpu_torch/dataio/synthetic.py at
commit ee4efae (lines named at each function), so a later change to the
port cannot change the traffic. Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Sim:
    """The trajectory and world parameters the frozen functions read
    (orcvio_tpu_torch/dataio/synthetic.py:26-44)."""
    n_frames: int = 100
    frame_hz: float = 20.0
    imu_hz: float = 200.0
    imu_slab: int = 24
    n_landmarks: int = 300
    max_obs: int = 60
    radius: float = 3.0
    omega: float = 0.6
    gravity: float = 9.81
    fov_limit: float = 1.2
    uv_noise: float = 0.002
    gyro_noise: float = 0.004
    acc_noise: float = 0.08
    seed: int = 0
    static_time: float = 0.0
    height: float = 0.0
    ramp_time: float = 1.0


def seeds(seed: int, n: int, stream: int = 0) -> list[int]:
    """n independent 63-bit seeds derived from the run's seed (any whole
    number) for one stream of draws: 0 the traffic's noise, others the
    drivers' own."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        n, np.uint64)
    return [int(s) >> 1 for s in state]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# --- frozen from orcvio_tpu_torch/dataio/synthetic.py at commit ee4efae:
# _warp_time_np 47-54, _so3_exp_np 57-69, trajectory_pose_np 72-88,
# _warp_derivs_np 91-101, _so3_right_jacobian_np 104-115, kinematics_np
# 118-147, _landmarks_np 156-166 ---

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


# --- the kind ---


def _sim(cfg: dict, mix: dict, n_frames: int) -> Sim:
    """The Sim of a configuration's sensors and a mix's trajectory."""
    keys = {f.name for f in dataclasses.fields(Sim)}
    vals = {**cfg["camera"], **cfg["imu"], **mix["trajectory"],
            "n_frames": n_frames}
    return Sim(**{k: v for k, v in vals.items() if k in keys})


def synthetic_tracks(cfg: dict, mix: dict, seed: int, device) -> dict:
    """B = mix["rows"] feature-message sequences of one landmark world
    (synthetic.py:generate's geometry, 183-236): the noise-free tracks
    and IMU once on the host, then each row's measurement and IMU noise
    drawn on the device from `seed`. Returns (B, T, ...) float64 tensors
    t, imu_t, gyro, acc, uvs, uv_vels, int32 fids, bool imu_mask and
    meas_mask, and the trajectory's (R0, p0, v0) at t = 0, on `device`."""
    B, T = mix["rows"], mix["frames"]
    sim = _sim(cfg, mix, T)
    slab = cfg["filter"]["imu_slab"]
    R_b2c = np.asarray(cfg["extrinsics"]["R_b2c"], np.float64)
    t_c_b = np.asarray(cfg["extrinsics"]["t_c_b"], np.float64)
    dt_f, dt_i = 1.0 / sim.frame_hz, 1.0 / sim.imu_hz
    lm = _landmarks_np(sim)
    frame_ts = (np.arange(T) + 1) * dt_f
    imu_t = frame_ts[:, None] - dt_f + dt_i * (1 + np.arange(slab))
    imu_mask = imu_t <= frame_ts[:, None] + 1e-9
    _, gyro, acc = kinematics_np(sim, imu_t.reshape(-1))
    gt_R, gt_p = trajectory_pose_np(sim, frame_ts)
    M = sim.max_obs
    fids = np.full((T, M), -1, np.int32)
    uvs = np.zeros((T, M, 2))
    meas = np.zeros((T, M), bool)
    for k in range(T):
        R_c2w = gt_R[k] @ R_b2c.T
        pc = (lm - (gt_p[k] + gt_R[k] @ t_c_b)) @ R_c2w
        z = np.maximum(pc[:, 2], 1e-6)
        vis = ((pc[:, 2] > 0.5) & (np.abs(pc[:, 0] / z) < sim.fov_limit)
               & (np.abs(pc[:, 1] / z) < sim.fov_limit))
        idx = np.nonzero(vis)[0][:M]
        fids[k, :len(idx)] = idx
        uvs[k, :len(idx)] = pc[idx, :2] / pc[idx, 2:3]
        meas[k, :len(idx)] = True
    g_uv, g_imu = (generator(s, device) for s in seeds(seed, 2))

    def rows(x, dtype=torch.float64):
        x = torch.as_tensor(x, device=device).to(dtype)
        return x.expand(B, *x.shape).contiguous()

    def noisy(x, sigma, g, mask):
        x = rows(x)
        n = torch.randn(x.shape, generator=g, dtype=x.dtype, device=device)
        return x + torch.where(mask, n * sigma, 0.0)

    m_uv = rows(meas, torch.bool)[..., None]
    m_imu = rows(imu_mask, torch.bool)[..., None]
    R0, p0 = trajectory_pose_np(sim, 0.0)
    v0 = kinematics_np(sim, 0.0)[0]
    return {"t": rows(frame_ts), "imu_t": rows(imu_t),
            "gyro": noisy(gyro.reshape(T, slab, 3), sim.gyro_noise, g_imu,
                          m_imu),
            "acc": noisy(acc.reshape(T, slab, 3), sim.acc_noise, g_imu, m_imu),
            "imu_mask": rows(imu_mask, torch.bool),
            "fids": rows(fids, torch.int32),
            "uvs": noisy(uvs, sim.uv_noise, g_uv, m_uv),
            "uv_vels": rows(np.zeros_like(uvs)),
            "meas_mask": rows(meas, torch.bool),
            "R0": torch.as_tensor(R0, device=device),
            "p0": torch.as_tensor(p0, device=device),
            "v0": torch.as_tensor(v0, device=device)}


KINDS = {"synthetic_tracks": synthetic_tracks}


def make(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The inputs of mix under cfg, from seed, on device."""
    return KINDS[mix["generator"]](cfg, mix, seed, device)
