"""The image stream of the end-to-end cells: a camera looking down at a
textured ground plane along the analytic trajectory, 8-bit frames and a
noisy IMU, made on the device in set-up.

Frozen from orcvio_tpu_torch/dataio/euroc_writer.py (``make_stream``
93-130, ``CameraModel`` 34-46, ``R_B2C_DOWN`` 49-51, ``WriterConfig``
54-65), orcvio_tpu_torch/dataio/synthetic.py (``_linear_resize_matrix``
239-250, ``smooth_texture`` 253-268, ``bilinear_sample`` 271-281,
``render_plane_view`` 284-305) and orcvio_tpu_torch/dataio/euroc.py
(``bin_imu_per_frame`` 64-95) at commit 748605c, so that a later change to
the port cannot change the traffic; the trajectory is ``generate.py``'s
frozen copy. Nothing here imports the port. One departure from the
writer: the IMU and image noise are drawn with torch on the device from
the run's seed (``generate.seeds(seed, 1, stream=0)``), IMU first, then
each frame's image, where the writer draws them with one numpy generator,
so that set-up stays short. The texture keeps the writer's own seed: it
is the scene, not the noise.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generate


def stream_sim(cfg: dict, mix: dict) -> generate.Sim:
    """The Sim of a configuration's sensors and a mix's trajectory."""
    keys = {f.name for f in generate.dataclasses.fields(generate.Sim)}
    vals = {**cfg["camera"], **cfg["imu"], **mix["trajectory"],
            "n_frames": cfg["n_frames"]}
    return generate.Sim(**{k: v for k, v in vals.items() if k in keys})


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a linear (triangle-kernel) resize with
    half-pixel centres and normalized weights."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def smooth_texture(H, W, seed, device, octaves=5, lo=40.0, hi=220.0):
    """Band-limited random texture, float32 (H, W) on `device`: octaves of
    seeded normal noise, each upsampled linearly to (H, W) in float64 and
    weighted 2**octave."""
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
    """The camera view of a textured z = 0 ground plane, on texture's
    device; pixels whose ray misses the plane render as 0."""
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


def bin_imu_per_frame(imu_t, gyro, acc, cam_t, slab: int,
                      imu_rate_hint: float = 200.0):
    """Frame k gets the IMU samples in (t_{k-1} + h, t_k + h], h = 0.5 /
    imu_rate, the newest `slab` of them. Returns (imu_t, gyro, acc, mask)
    stacked (K, slab, ...) with exact-zero padding."""
    K = len(cam_t)
    out_t = np.zeros((K, slab))
    out_g = np.zeros((K, slab, 3))
    out_a = np.zeros((K, slab, 3))
    out_m = np.zeros((K, slab), bool)
    idx = np.searchsorted(imu_t, cam_t + 0.5 / imu_rate_hint, side="right")
    start = 0
    for k in range(K):
        end = idx[k]
        sel = slice(max(start, end - slab), end)
        n = sel.stop - sel.start
        out_t[k, :n] = imu_t[sel]
        out_g[k, :n] = gyro[sel]
        out_a[k, :n] = acc[sel]
        out_m[k, :n] = True
        start = end
    return out_t, out_g, out_a, out_m


def make(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The stream of a configuration and a mix on `device`: uint8 images
    (T, H, W); frame times (T,); the IMU binned per frame, times (T, S),
    gyro and acc (T, S, 3) with bias and the seed's noise, a mask (T, S);
    all floats float64."""
    sim = stream_sim(cfg, mix)
    cam, w = cfg["camera"], cfg["writer"]
    H, W = cam["height"], cam["width"]
    K = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    n = sim.n_frames
    dt_f, dt_i = 1.0 / sim.frame_hz, 1.0 / sim.imu_hz
    frame_ts = (np.arange(n) + 1) * dt_f
    imu_ts = dt_i * (1 + np.arange(int(round((n + 1) * dt_f * sim.imu_hz))))
    gt_R, gt_p = generate.trajectory_pose_np(sim, frame_ts)
    _, gyro, acc = generate.kinematics_np(sim, imu_ts)

    g = generate.generator(generate.seeds(seed, 1, stream=0)[0], device)
    f64 = dict(dtype=torch.float64, device=device)
    gyro = (torch.as_tensor(gyro, **f64)
            + torch.randn(gyro.shape, generator=g, **f64) * sim.gyro_noise
            + torch.as_tensor(w["gyro_bias"], **f64))
    acc = (torch.as_tensor(acc, **f64)
           + torch.randn(acc.shape, generator=g, **f64) * sim.acc_noise
           + torch.as_tensor(w["acc_bias"], **f64))

    tex = smooth_texture(w["tex_size"], w["tex_size"], w["tex_seed"], device)
    R_b2c = np.asarray(cfg["extrinsics"]["R_b2c"])
    R_c2w = torch.as_tensor(gt_R @ R_b2c.T).to(device)
    t_cw = torch.as_tensor(
        gt_p + gt_R @ np.asarray(cfg["extrinsics"]["t_c_b"])).to(device)
    images = torch.empty((n, H, W), dtype=torch.uint8, device=device)
    for k in range(n):
        img = render_plane_view(tex, w["tex_scale"], R_c2w[k], t_cw[k], K,
                                H, W)
        img = img + torch.randn(img.shape, generator=g, dtype=img.dtype,
                                device=device) * w["image_noise"]
        images[k] = torch.clamp(img, 0, 255).to(torch.uint8)
    imu = bin_imu_per_frame(imu_ts, gyro.cpu().numpy(), acc.cpu().numpy(),
                            frame_ts, cfg["filter"]["imu_slab"])
    out = {"images": images, "frame_ts": torch.as_tensor(frame_ts, **f64)}
    for name, x in zip(("imu_t", "gyro", "acc"), imu[:3]):
        out[name] = torch.as_tensor(x, **f64)
    out["imu_mask"] = torch.as_tensor(imu[3], device=device)
    return out
