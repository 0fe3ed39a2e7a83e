"""Pyramidal Lucas-Kanade feature tracking, batched over features.

Counterpart of ``orcvio_tpu/frontend/klt.py`` (reference:
cv::calcOpticalFlowPyrLK, image_processor.cpp:568,628, forward + reverse
with a 1 px consistency gate).

Per level, each feature's window is cut from the tile-aligned level image
by kernel K1 (``ops/dma_gather.py``) at the full (48, 256) extent the TPU
path keeps, and the template and all LK iterations run in kernel K2
(``ops/lk_pallas.py``). The backward consistency pass reuses the level-0
windows of the forward pass.

LK stops per feature once its step norm is at most ``KLT_EPS`` (as
cv::TermCriteria does) or after ``iters`` steps. ``KLT_EPS = 0`` gives the
JAX package's fixed-count CPU loop; the parity tests set it so.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.lk_pallas import AUX_W, lk_level_fused, resample
from ..ops.window_gather import AlignedImage, gather_windows, prepare_image

SEARCH_WD = 36       # logical search-window span (patch 15 + 2*9 radius + 2)
ROWS, LANES = 48, 128  # window rows, and the lane unit (windows are 2 units)
KLT_EPS = 0.01       # per-feature step-norm stop (cv::TermCriteria EPS)
MARGIN = 40          # edge padding of each prepared pyramid level


class KltResult(NamedTuple):
    xy: torch.Tensor  # (N, 2) tracked positions (level-0 pixels)
    ok: torch.Tensor  # (N,) converged & in-bounds & residual sane


class LevelWindows(NamedTuple):
    win: torch.Tensor     # (N, ROWS, 2*LANES) pixels
    origin: torch.Tensor  # (N, 2) xy of win[:, 0, 0] in image coords
    start: torch.Tensor   # (N, 2) xy of the logical search window start


def prepare_pyramid(pyr):
    """Prepare each pyramid level for window gathering (once per frame)."""
    return tuple(prepare_image(img[None], margin=MARGIN) for img in pyr)


def gather_level(ai: AlignedImage, centers) -> LevelWindows:
    """The (ROWS, 2*LANES) window around floor(centers) - SEARCH_WD//2."""
    t0 = -(SEARCH_WD // 2)
    win, origin = gather_windows(ai, centers, t0, SEARCH_WD, ROWS, 2 * LANES)
    H, W = ai.shape
    cf = torch.floor(centers)
    start = torch.stack([torch.clamp(cf[:, 0], 0, W - 1) + t0,
                         torch.clamp(cf[:, 1], 0, H - 1) + t0], dim=1)
    return LevelWindows(win=win[0], origin=origin, start=start)


def _level_aux(lw0: LevelWindows, lw1: LevelWindows, xy0, p_init,
               patch: int):
    """K2's per-feature inputs in window-local coordinates, and the search
    bounds (lo, hi) in win1's frame."""
    r = (patch - 1) // 2
    lo = lw1.start - lw1.origin + r
    hi = lo + (SEARCH_WD - 2 * r - 1.001)
    aux = torch.zeros((p_init.shape[0], AUX_W), dtype=p_init.dtype,
                      device=p_init.device)
    aux[:, 0:2] = xy0 - lw0.origin
    aux[:, 4:6] = lo
    aux[:, 6:8] = hi
    aux[:, 10:12] = p_init - lw1.origin
    return aux, lo, hi


def _lk_level(lw0: LevelWindows, lw1: LevelWindows, xy0, p_init, patch: int,
              iters: int):
    """One level: template from lw0 at xy0, LK over lw1 from p_init (K2).

    Returns (p, residual, conv) with p in image coordinates."""
    aux, lo, hi = _level_aux(lw0, lw1, xy0, p_init, patch)
    out = lk_level_fused(lw0.win, lw1.win, aux, iters, patch, KLT_EPS)
    return _level_result(out, lw1, lo, hi)


def _level_result(out, lw1: LevelWindows, lo, hi):
    """(p in image coords, residual, conv) from K2's output rows: converged
    = a well-conditioned template, a last step under 1 px, and a final
    position strictly inside the search bounds."""
    lxy = out[:, :2]
    interior = ((lxy > lo + 1e-3) & (lxy < hi - 1e-3)).all(dim=1)
    conv = (out[:, 4] > 1e-6) & (out[:, 3] < 1.0) & interior
    return lw1.origin + lxy, out[:, 2], conv


def _pyr_track_prepared(ais0, ais1, xy0, xy1_guess, patch, iters,
                        max_residual: float = 25.0):
    """Coarse-to-fine forward LK, then the level-0 backward pass.

    Returns (KltResult of the forward track, forward-backward distance)."""
    levels = len(ais0)
    scale = 2.0 ** (levels - 1)
    p1 = xy1_guess / scale
    lw0_l0 = lw1_l0 = None
    for lv in range(levels - 1, -1, -1):
        p0_lv = xy0 / 2.0 ** lv
        if lv != levels - 1:
            p1 = p1 * 2.0
        lw0 = gather_level(ais0[lv], p0_lv)
        lw1 = gather_level(ais1[lv], p1)
        p1, res, conv = _lk_level(lw0, lw1, p0_lv, p1, patch, iters)
        if lv == 0:
            lw0_l0, lw1_l0 = lw0, lw1
    H, W = ais0[0].shape
    inb = ((p1[:, 0] > 2) & (p1[:, 0] < W - 3)
           & (p1[:, 1] > 2) & (p1[:, 1] < H - 3))
    fwd_ok = conv & inb & (res < max_residual)
    # backward pass at level 0, reusing the forward windows: template from
    # the img1 window at the forward result, iterate over the img0 window
    # starting at xy0 (flow magnitude <= search radius by construction)
    q, _res_b, conv_b = _lk_level(lw1_l0, lw0_l0, p1, xy0, patch, iters)
    fb = torch.linalg.norm(q - xy0, dim=1)
    return KltResult(xy=p1, ok=fwd_ok & conv_b), fb


def forward_backward_track(pyr0, pyr1, xy0, xy1_guess, patch: int = 15,
                           iters: int = 10, fb_thresh: float = 1.0):
    """Forward LK + level-0 reverse consistency gate
    (image_processor.cpp:628-652) over prepared pyramids (tuples of
    AlignedImage, level 0 = full res)."""
    res, fb = _pyr_track_prepared(pyr0, pyr1, xy0, xy1_guess, patch, iters)
    return KltResult(xy=res.xy, ok=res.ok & (fb < fb_thresh))


def extract_patches(img, centers, taps):
    """Bilinear patches at subpixel centers (ORB's patch reads).

    img: (H, W) or prepared AlignedImage; centers: (N, 2) xy; taps: (P,)
    consecutive integer offsets. Returns (N, P, P).
    """
    taps = np.asarray(taps)
    P = int(taps.shape[0])
    ai = img if isinstance(img, AlignedImage) else prepare_image(
        img[None], margin=MARGIN)
    rows = -(-(P + 1 + 7) // 8) * 8
    win, origin = gather_windows(ai, centers, int(taps[0]), P + 1,
                                 max(rows, 16), 2 * LANES)
    local = centers - origin + int(taps[0])
    return resample(win[0], local[:, 0], local[:, 1], P)
