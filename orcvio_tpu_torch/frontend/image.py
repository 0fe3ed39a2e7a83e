"""Image primitives: pyramid, gradients, histogram equalization.

Counterpart of ``orcvio_tpu/frontend/image.py`` (reference:
createImagePyramids, image_processor.cpp:322). The separable blur stays two
dense banded products ``B_H @ img @ B_W^T`` with the same float32 band
weights, so the port rounds exactly where the JAX package does. Images are
(H, W) floating tensors in [0, 255].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_GAUSS5 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, kernel: tuple, stride: int = 1):
    """Banded 1D-convolution operator as a dense float32 matrix.

    Edge padding is folded into the band weights; stride-2 downsampling is
    every other row of the operator."""
    B = np.zeros((n, n), np.float32)
    pad = len(kernel) // 2
    rows = np.arange(n)
    for o, w in enumerate(kernel):
        idx = np.clip(rows + o - pad, 0, n - 1)
        np.add.at(B, (rows, idx), w)
    return B[::stride]


@functools.lru_cache(maxsize=64)
def _band_tensor(n: int, kernel: tuple, stride: int, dtype, device):
    return torch.as_tensor(_band_matrix(n, kernel, stride)).to(
        device=device, dtype=dtype)


def _sep_conv(img, k, stride: int = 1):
    """Separable 2D convolution with edge padding via banded matmuls.

    k is a static kernel (tuple / numpy array)."""
    H, W = img.shape
    kt = tuple(float(v) for v in np.asarray(k))
    BH = _band_tensor(H, kt, stride, img.dtype, img.device)
    BW = _band_tensor(W, kt, stride, img.dtype, img.device)
    return BH @ img @ BW.T


def blur_downsample(img):
    """Gaussian blur fused with stride-2 downsample."""
    return _sep_conv(img, _GAUSS5, stride=2)


def build_pyramid(img, levels: int):
    """[level0 (full res), level1 (half), ...]."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(blur_downsample(pyr[-1]))
    return pyr


def gradients(img):
    """Central-difference gradients (Ix, Iy) with edge padding."""
    gx = torch.cat([img[:, :1], img, img[:, -1:]], dim=1)
    Ix = gx[:, 2:] * 0.5 - gx[:, :-2] * 0.5
    gy = torch.cat([img[:1], img, img[-1:]], dim=0)
    Iy = gy[2:, :] * 0.5 - gy[:-2, :] * 0.5
    return Ix, Iy


@functools.lru_cache(maxsize=8)
def _poly_fit_matrix(bins: int, degree: int):
    """(degree+1, bins) least-squares operator: coef = M @ cdf."""
    x = np.linspace(0.0, 1.0, bins)
    V = np.stack([x**d for d in range(degree + 1)], axis=1)  # (bins, d+1)
    M = np.linalg.solve(V.T @ V, V.T)
    return M.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _poly_fit_tensor(bins: int, degree: int, dtype, device):
    return torch.as_tensor(_poly_fit_matrix(bins, degree)).to(
        device=device, dtype=dtype)


def equalize_hist(img, bins: int = 64, subsample: int = 4, degree: int = 8):
    """Global histogram equalization, the JAX package's "poly" mode.

    A `bins`-bin histogram over a `subsample`-strided pixel grid, its CDF,
    a degree-`degree` least-squares polynomial fit of the CDF (precomputed
    float32 operator), applied to every pixel by Horner's rule. The
    histogram is a scatter-add into a fixed number of bins (bincount would
    read its input's maximum back to the host)."""
    flat = torch.clamp(img, 0.0, 255.0)
    sub = flat[::subsample, ::subsample]
    idx = torch.clamp(sub / 255.0 * (bins - 1), 0.0, bins - 1.0).round()
    idx = idx.to(torch.int64).reshape(-1)
    hist = torch.zeros(bins, dtype=img.dtype, device=img.device).scatter_add(
        0, idx, torch.ones_like(idx, dtype=img.dtype))
    cdf = torch.cumsum(hist, dim=0)
    cdf = cdf / cdf[-1]
    coef = _poly_fit_tensor(bins, degree, img.dtype, img.device) @ cdf
    xn = flat * (1.0 / 255.0)
    out = coef[degree]
    for d in range(degree - 1, -1, -1):
        out = out * xn + coef[d]
    return torch.clamp(out, 0.0, 1.0) * 255.0
