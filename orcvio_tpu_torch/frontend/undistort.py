"""Camera distortion models: radtan + equidistant, distort & iterative undistort.

Counterpart of ``orcvio_tpu/frontend/undistort.py`` (reference:
image_processor.cpp:1050-1084). Fixed-point inversion, 8 iterations,
batched over points.
"""
from __future__ import annotations

import torch


def distort_radtan(xy, k1, k2, p1, p2):
    """Normalized ideal -> distorted normalized (radial-tangential)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_radtan(xy_d, k1, k2, p1, p2, iters: int = 8):
    """Distorted normalized -> ideal normalized (fixed-point iteration)."""
    x0, y0 = xy_d[..., 0], xy_d[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x, y], dim=-1)


def distort_equidistant(xy, k1, k2, k3, k4):
    """Kannala-Brandt fisheye model."""
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_equidistant(xy_d, k1, k2, k3, k4, iters: int = 8):
    x, y = xy_d[..., 0], xy_d[..., 1]
    theta_d = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        theta = theta_d / (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3
                           + k4 * t2**4)
    scale = torch.tan(theta) / theta_d
    return torch.stack([x * scale, y * scale], dim=-1)


def pixel_to_normalized(uv, K):
    """(u, v) pixels -> normalized; K = (fx, fy, cx, cy)."""
    fx, fy, cx, cy = K
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy],
                       dim=-1)


def normalized_to_pixel(xy, K):
    fx, fy, cx, cy = K
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def undistort_pixels(uv, K, model: str, coeffs):
    """Distorted pixels -> ideal normalized coords (the filter's input space)."""
    xy_d = pixel_to_normalized(uv, K)
    if model == "radtan":
        return undistort_radtan(xy_d, *coeffs)
    if model == "equidistant":
        return undistort_equidistant(xy_d, *coeffs)
    if model == "none":
        return xy_d
    raise ValueError(f"unknown distortion model {model}")
