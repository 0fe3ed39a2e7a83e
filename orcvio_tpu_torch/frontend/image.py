"""Image primitives: pyramid, gradients, bilinear sampling, equalization.

Counterpart of ``orcvio_tpu/frontend/image.py`` (reference:
createImagePyramids, image_processor.cpp:322, which equalizes with
cv::createCLAHE under flag_equalize). The separable blur stays two dense
banded products ``B_H @ img @ B_W^T`` with the same float32 band weights,
so the port rounds exactly where the JAX package does. Images are (H, W)
floating tensors in [0, 255].
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


def gaussian_blur(img):
    """5-tap Gaussian blur with edge padding."""
    return _sep_conv(img, _GAUSS5)


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


def bilinear_sample(img, xy):
    """img sampled at subpixel locations xy (..., 2) = (x, y); positions
    are clamped into the image."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def sample_patch(img, center_xy, offsets):
    """Bilinear patch around a center: offsets (P, 2) -> values (P,)."""
    return bilinear_sample(img, center_xy[None, :] + offsets)


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


def equalize_hist(img, bins: int = 64, knots: int = 32, subsample: int = 4,
                  mode: str = "poly", degree: int = 8):
    """Global histogram equalization (the JAX package's stand-in for CLAHE).

    A `bins`-bin histogram over a `subsample`-strided pixel grid and its
    CDF, applied to every pixel in one of two modes:

    * "poly" (default): a degree-`degree` least-squares polynomial fit of
      the CDF (precomputed float32 operator), by Horner's rule;
    * "pwl": the piecewise-linear map through the CDF at `knots` + 1
      equispaced gray levels, as a sum of clipped ramps.

    The histogram is a scatter-add into a fixed number of bins (bincount
    would read its input's maximum back to the host)."""
    flat = torch.clamp(img, 0.0, 255.0)
    sub = flat[::subsample, ::subsample]
    idx = torch.clamp(sub / 255.0 * (bins - 1), 0.0, bins - 1.0).round()
    idx = idx.to(torch.int64).reshape(-1)
    hist = torch.zeros(bins, dtype=img.dtype, device=img.device).scatter_add(
        0, idx, torch.ones_like(idx, dtype=img.dtype))
    cdf = torch.cumsum(hist, dim=0)
    cdf = cdf / cdf[-1]
    if mode == "poly":
        coef = _poly_fit_tensor(bins, degree, img.dtype, img.device) @ cdf
        xn = flat * (1.0 / 255.0)
        out = coef[degree]
        for d in range(degree - 1, -1, -1):
            out = out * xn + coef[d]
        return torch.clamp(out, 0.0, 1.0) * 255.0
    if mode != "pwl":
        raise ValueError(f"equalize_hist: unknown mode {mode!r}: expected "
                         "'poly' or 'pwl'")
    step = (bins - 1) / knots
    knot_pos = torch.arange(knots + 1, dtype=img.dtype,
                            device=img.device) * step
    knot_val = cdf[torch.clamp(knot_pos.round(), 0, bins - 1).long()]
    x = torch.clamp(flat / 255.0 * (bins - 1), 0.0, bins - 1.0)
    seg = x[..., None] / step - torch.arange(knots, dtype=img.dtype,
                                             device=img.device)
    w_hi = torch.clamp(seg, 0.0, 1.0)  # (H, W, knots)
    out = knot_val[0] + torch.sum(w_hi * (knot_val[1:] - knot_val[:-1]),
                                  dim=-1)
    return out * 255.0


def clahe(img, grid=(8, 8), clip_limit: float = 3.0, bins: int = 256):
    """Contrast-limited adaptive histogram equalization (cv::CLAHE's
    scheme): the image padded at its edges to whole tiles, one clipped
    `bins`-bin histogram a tile (one scatter-add builds them all; the
    counts are whole numbers, so the order of the adds does not matter),
    the clipped mass spread evenly over the bins, each tile's CDF as a
    lookup table, and each pixel interpolated bilinearly between the
    tables of the four nearest tile centers."""
    H, W = img.shape
    gh, gw = grid
    th = -(-H // gh)
    tw = -(-W // gw)
    Hp, Wp = th * gh, tw * gw
    dev, dtype = img.device, img.dtype
    x = torch.nn.functional.pad(torch.clamp(img, 0.0, 255.0)[None, None],
                                (0, Wp - W, 0, Hp - H), mode="replicate")[0, 0]

    # casts to integer truncate toward zero, as JAX's astype does
    b = torch.clamp((x / 255.0 * (bins - 1)).to(torch.int32), 0, bins - 1)
    tile_r = torch.arange(Hp, device=dev)[:, None] // th
    tile_c = torch.arange(Wp, device=dev)[None, :] // tw
    tile_id = tile_r * gw + tile_c
    flat = (tile_id * bins + b).reshape(-1)
    hist = torch.zeros(gh * gw * bins, dtype=dtype, device=dev).index_add(
        0, flat, torch.ones(flat.shape, dtype=dtype, device=dev))
    hist = hist.reshape(gh * gw, bins)

    # clip and redistribute (one pass, the standard CLAHE approximation)
    clip = clip_limit * (th * tw) / bins
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / bins

    cdf = torch.cumsum(hist, dim=1)
    cdf = cdf / cdf[:, -1:]
    lut = cdf * 255.0  # (n_tiles, bins)

    # bilinear interpolation between tile centers
    cy = (torch.arange(Hp, dtype=dtype, device=dev) - th / 2.0) / th
    cx = (torch.arange(Wp, dtype=dtype, device=dev) - tw / 2.0) / tw
    r0 = torch.clamp(torch.floor(cy).to(torch.int32), 0, gh - 1)
    c0 = torch.clamp(torch.floor(cx).to(torch.int32), 0, gw - 1)
    r1 = torch.clamp(r0 + 1, 0, gh - 1)
    c1 = torch.clamp(c0 + 1, 0, gw - 1)
    fy = torch.clamp(cy - r0, 0.0, 1.0)[:, None]
    fx = torch.clamp(cx - c0, 0.0, 1.0)[None, :]
    bl = b.long()

    def look(rr, cc):
        tid = (rr[:, None] * gw + cc[None, :]).long()
        return lut[tid, bl]

    out = (look(r0, c0) * (1 - fy) * (1 - fx)
           + look(r0, c1) * (1 - fy) * fx
           + look(r1, c0) * fy * (1 - fx)
           + look(r1, c1) * fy * fx)
    return out[:H, :W]
