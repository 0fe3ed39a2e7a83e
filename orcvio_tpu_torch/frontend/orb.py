"""Rotated-BRIEF binary descriptors + Hamming distance gate.

Counterpart of ``orcvio_tpu/frontend/orb.py`` (reference: the ORB_SLAM2
descriptor stage, src/ORBDescriptor.cpp, gated at Hamming distance <= 58,
image_processor.cpp:463,707): a seeded Gaussian 256-pair pattern, the
intensity-centroid orientation, and 256-bit descriptors in eight 32-bit
words. torch's uint32 supports few operations, so each word is an int64
holding a 32-bit value.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .klt import extract_patches

N_BITS = 256
PATCH_R = 15.0
_P = 33  # patch side: radius 15 pattern + 1 texel margin for bilinear taps
_R = _P // 2


def make_pattern(seed: int = 42):
    """(256, 4) sampling pairs (x1, y1, x2, y2), Gaussian sigma = r/2,
    clipped, rounded to float32 as the JAX package stores them."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_R / 2.0, size=(N_BITS, 4))
    return torch.as_tensor(np.clip(pts, -PATCH_R, PATCH_R).astype(np.float32))


_PATTERN = make_pattern()


@functools.lru_cache(maxsize=8)
def _pattern_on(dtype, device):
    """The default pattern, copied to the device once (a copy per frame
    would wait for the device)."""
    return _PATTERN.to(device=device, dtype=dtype)


def _keypoint_patches(img, xy):
    """(N, 33, 33) pixel patches around each keypoint."""
    return extract_patches(img, xy, np.arange(-_R, _R + 1))


def _orientation_from_patches(patches):
    o = torch.arange(-_R, _R + 1, dtype=patches.dtype, device=patches.device)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    circ = ((ox * ox + oy * oy) <= PATCH_R * PATCH_R).to(patches.dtype)
    m10 = torch.sum(patches * (ox * circ)[None], dim=(1, 2))
    m01 = torch.sum(patches * (oy * circ)[None], dim=(1, 2))
    return torch.atan2(m01, m10)


def orientation(img, xy):
    """Intensity-centroid orientation per keypoint (IC_Angle in ORB)."""
    return _orientation_from_patches(_keypoint_patches(img, xy))


def _sample_in_patch(patches, pts):
    """Bilinear sample (N, M, 2) patch-frame points from (N, P, P) patches:
    a row lerp, then a column lerp."""
    c = torch.clamp(pts + _R, 0.0, _P - 1.001)  # patch coords
    c0 = torch.floor(c)
    f = c - c0
    iy, ix = c0[..., 1].long(), c0[..., 0].long()
    fy, fx = f[..., 1], f[..., 0]
    n = torch.arange(patches.shape[0], device=patches.device)[:, None]
    col0 = patches[n, iy, ix] * (1 - fy) + patches[n, iy + 1, ix] * fy
    col1 = patches[n, iy, ix + 1] * (1 - fy) + patches[n, iy + 1, ix + 1] * fy
    return col0 * (1 - fx) + col1 * fx


def describe(img, xy, angles=None, pattern=None):
    """Descriptors (N, 8) int64, each word a 32-bit value. img may be a raw
    (H, W) image or a prepared ops.window_gather.AlignedImage; pattern
    defaults to make_pattern()."""
    patches = _keypoint_patches(img, xy)
    if angles is None:
        angles = _orientation_from_patches(patches)
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]
    pattern = (_pattern_on(patches.dtype, patches.device) if pattern is None
               else pattern.to(device=patches.device, dtype=patches.dtype))

    def rot(p):  # (256, 2) pattern points -> (N, 256, 2) rotated
        return torch.stack(
            [c * p[None, :, 0] - s * p[None, :, 1],
             s * p[None, :, 0] + c * p[None, :, 1]], dim=-1)

    v1 = _sample_in_patch(patches, rot(pattern[:, 0:2]))
    v2 = _sample_in_patch(patches, rot(pattern[:, 2:4]))
    words = (v1 < v2).reshape(-1, 8, 32)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=xy.device),
        torch.arange(32, device=xy.device))
    return torch.sum(torch.where(words, weights, 0), dim=-1)


def hamming(d1, d2):
    """Bitwise Hamming distance between (N, 8) descriptor word arrays."""
    x = torch.bitwise_xor(d1, d2)
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    per_word = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return torch.sum(per_word, dim=-1, dtype=torch.int32)
