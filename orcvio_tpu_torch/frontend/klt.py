"""Pyramidal Lucas-Kanade feature tracking, batched over features.

Counterpart of ``orcvio_tpu/frontend/klt.py`` (reference:
cv::calcOpticalFlowPyrLK, image_processor.cpp:568,628, forward + reverse
with a 1 px consistency gate).

Per level, each feature has a (48, 256) window of the tile-aligned level
image, the extent the TPU path keeps, and the template and all LK
iterations run in kernel K2 (``ops/lk_pallas.py``). On the card K2 reads
the windows in place in the padded level (``lk_level_src``, the level
route): ``gather_level(..., cut=False)`` gives their offsets and no window
is written. On the CPU K1 (``ops/dma_gather.py``) cuts them and K2's plain
version runs on them, as the JAX package's CPU path does; both routes read
the same pixels. The backward consistency pass reuses the level-0 windows
(or offsets) of the forward pass. ``forward_backward_track`` and
``pyr_track`` take raw level tensors or prepared ``AlignedImage`` levels.

LK stops per feature once its step norm is at most ``KLT_EPS`` (as
cv::TermCriteria does) or after ``iters`` steps. ``KLT_EPS = 0`` gives the
JAX package's fixed-count CPU loop; the parity tests set it so.

``track_level`` runs one level as template then iterations: ``_template``
in plain PyTorch over the window K1 cuts from the first image, then
``_lk_dispatch``, whose one route here is ``_lk_iterate_pallas`` and kernel
K3 (fixed count, no eps). On the card K3 reads the second image in place
(``lk_iterate_src``), as K2 does, so K1 launches once a call; on the CPU
the window is cut and K3's plain version runs on it. The JAX package's
``track_level`` calls ``_lk_iterate`` directly, the non-TPU side of its own
``_lk_dispatch``; both compute the same function, and this is what gives K3
a caller. ``_lk_iterate`` here runs the same loop through K3's plain
version on any device: the reference K3 is held to.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.lk_pallas import (lk_iterate_fused, lk_iterate_fused_plain,
                             lk_iterate_src, lk_iterate_src_plain,
                             lk_level_fused, lk_level_src, resample)
from ..ops.window_gather import (AlignedImage, gather_windows, prepare_image,
                                 window_offsets, window_origins)

SEARCH_WD = 36       # logical search-window span (patch 15 + 2*9 radius + 2)
ROWS, LANES = 48, 128  # window rows, and the lane unit (windows are 2 units)
KLT_EPS = 0.01       # per-feature step-norm stop (cv::TermCriteria EPS)
MARGIN = 40          # edge padding of each prepared pyramid level


class KltResult(NamedTuple):
    xy: torch.Tensor  # (N, 2) tracked positions (level-0 pixels)
    ok: torch.Tensor  # (N,) converged & in-bounds & residual sane


class LevelWindows(NamedTuple):
    win: torch.Tensor | None  # (N, ROWS, 2*LANES) pixels; None if not cut
    origin: torch.Tensor  # (N, 2) xy of win[:, 0, 0] in image coords
    start: torch.Tensor   # (N, 2) xy of the logical search window start
    level: torch.Tensor | None = None   # (Hp, Wp) padded level, if not cut
    offset: torch.Tensor | None = None  # (N,) int64 window offsets in level


def prepare_pyramid(pyr):
    """Prepare each pyramid level for window gathering (once per frame)."""
    return tuple(prepare_image(img[None], margin=MARGIN) for img in pyr)


def gather_level(ai: AlignedImage, centers, cut: bool = True) -> LevelWindows:
    """The (ROWS, 2*LANES) window around floor(centers) - SEARCH_WD//2: cut
    by K1, or with cut=False located only (the level and each window's
    offset in it, for K2's level route)."""
    t0 = -(SEARCH_WD // 2)
    H, W = ai.shape
    cf = torch.floor(centers)
    start = torch.stack([torch.clamp(cf[:, 0], 0, W - 1) + t0,
                         torch.clamp(cf[:, 1], 0, H - 1) + t0], dim=1)
    if cut:
        win, origin = gather_windows(ai, centers, t0, SEARCH_WD, ROWS,
                                     2 * LANES)
        return LevelWindows(win=win[0], origin=origin, start=start)
    r0, c0, origin = window_origins(ai, centers, t0, ROWS, 2 * LANES)
    return LevelWindows(win=None, origin=origin, start=start,
                        level=ai.padded[0], offset=window_offsets(ai, r0, c0))


def _search_bounds(lw: LevelWindows, patch: int):
    """(lo, hi) of a patch centre in the search window, in lw's frame."""
    r = (patch - 1) // 2
    lo = lw.start - lw.origin + r
    return lo, lo + (SEARCH_WD - 2 * r - 1.001)


def _level_aux(lw0: LevelWindows, lw1: LevelWindows, xy0, p_init,
               patch: int):
    """K2's per-feature inputs in window-local coordinates, and the search
    bounds (lo, hi) in win1's frame."""
    lo, hi = _search_bounds(lw1, patch)
    z = torch.zeros_like(p_init)
    aux = _aux(p_init, xy0 - lw0.origin, z, lo, hi, z,
               p_init - lw1.origin, z, z)
    return aux, lo, hi


def _aux(like, *cols):
    """(N, AUX_W) aux (ops/lk_pallas.py's layout) from its column blocks, each (N, k), in like's dtype:
    built out of place, so that it batches under torch.func.vmap."""
    return torch.cat([c.to(like.dtype) for c in cols], dim=-1)


def _lk_level(lw0: LevelWindows, lw1: LevelWindows, xy0, p_init, patch: int,
              iters: int):
    """One level: template from lw0 at xy0, LK over lw1 from p_init (K2,
    over the cut windows or, where they were not cut, over the levels).

    Returns (p, residual, conv) with p in image coordinates."""
    aux, lo, hi = _level_aux(lw0, lw1, xy0, p_init, patch)
    if lw1.win is None:
        out = lk_level_src(lw0.level, lw0.offset, lw1.level, lw1.offset, aux,
                           iters, patch, KLT_EPS, ROWS, 2 * LANES)
    else:
        out = lk_level_fused(lw0.win, lw1.win, aux, iters, patch, KLT_EPS)
    return _level_result(out, lw1, lo, hi)


def _level_result(out, lw1: LevelWindows, lo, hi):
    """(p in image coords, residual, conv) from K2's output rows."""
    conv = _converged(out[:, :2], out[:, 3], out[:, 4], lo, hi)
    return lw1.origin + out[:, :2], out[:, 2], conv


def _converged(lxy, step, det, lo, hi):
    """A well-conditioned template, a last step under 1 px, and a final
    position strictly inside the search bounds. A NaN row (K2's mark of a
    feature whose bounds its tile cannot hold) fails every comparison, so
    it is never converged."""
    interior = ((lxy > lo + 1e-3) & (lxy < hi - 1e-3)).all(dim=1)
    return (det > 1e-6) & (step < 1.0) & interior


def _template(lw: LevelWindows, xy, patch: int):
    """Template patch, gradients and Hessian terms at subpixel centers xy:
    central-difference gradient maps over each window (zero in its edge
    rows and columns), then the sampler on the three channels."""
    r = (patch - 1) // 2
    win = lw.win
    gx = F.pad(0.5 * (win[:, :, 2:] - win[:, :, :-2]), (1, 1))
    gy = F.pad(0.5 * (win[:, 2:, :] - win[:, :-2, :]), (0, 0, 1, 1))
    local = xy - lw.origin - r  # patch (0, 0) tap
    t, tgx, tgy = (resample(c, local[:, 0], local[:, 1], patch)
                   for c in (win, gx, gy))
    a11 = torch.sum(tgx * tgx, dim=(1, 2))
    a12 = torch.sum(tgx * tgy, dim=(1, 2))
    a22 = torch.sum(tgy * tgy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    return t, tgx, tgy, a11, a12, a22, det


def _iterate_aux(lw: LevelWindows, tmpl, p_init, patch: int):
    """K3's per-feature inputs in window-local coordinates, and the search
    bounds (lo, hi)."""
    _, _, _, a11, a12, a22, det = tmpl
    lo, hi = _search_bounds(lw, patch)
    det_safe = torch.where(det > 1e-6, det, torch.ones_like(det))
    z = torch.zeros_like(p_init)
    aux = _aux(p_init, torch.stack([a11, a12, a22, det_safe], dim=-1), lo,
               hi, z, p_init - lw.origin, z, z)
    return aux, lo, hi


def _iterate(lw: LevelWindows, tmpl, p_init, patch: int, iters: int,
             plain: bool):
    """Fixed-count LK of p over lw against tmpl: K3 (with `plain`, its plain
    version), over the cut window or, where it was not cut, over the level
    in place. Returns (p, residual, conv), p in image coordinates; iterates
    that leave the search window are clamped."""
    aux, lo, hi = _iterate_aux(lw, tmpl, p_init, patch)
    t, tgx, tgy = tmpl[:3]
    if lw.win is None:
        src = lk_iterate_src_plain if plain else lk_iterate_src
        out = src(lw.level, lw.offset, t, tgx, tgy, aux, iters, patch, ROWS,
                  2 * LANES)
    else:
        win = lk_iterate_fused_plain if plain else lk_iterate_fused
        out = win(lw.win, t, tgx, tgy, aux, iters, patch)
    conv = _converged(out[:, :2], out[:, 3], tmpl[6], lo, hi)
    return lw.origin + out[:, :2], out[:, 2], conv


def _lk_iterate(lw: LevelWindows, tmpl, p_init, patch: int, iters: int):
    """The JAX package's fixed-count loop, through K3's plain version on
    any device."""
    return _iterate(lw, tmpl, p_init, patch, iters, plain=True)


def _lk_iterate_pallas(lw: LevelWindows, tmpl, p_init, patch: int,
                       iters: int):
    """The same loop in one launch of K3 (its plain version on the CPU)."""
    return _iterate(lw, tmpl, p_init, patch, iters, plain=False)


def _lk_dispatch(lw: LevelWindows, tmpl, p_init, patch: int, iters: int):
    """The level's iterations: the kernel route, the port's only one."""
    return _lk_iterate_pallas(lw, tmpl, p_init, patch, iters)


def track_level(img0, img1, xy0, xy1_init, patch: int, iters: int,
                eps: float, search_radius: int = 9):
    """One pyramid level of LK for all features over raw (H, W) level
    images: the template from img0 at xy0, then `iters` steps over img1
    from xy1_init (K3). eps and search_radius are ignored, as in the JAX
    package. The template's window of img0 is cut (K1); on the card K3
    reads img1's padded level in place, on the CPU its window is cut.
    Returns (p, residual, conv)."""
    del eps, search_radius
    lw0 = gather_level(prepare_image(img0[None], margin=MARGIN), xy0)
    ai1 = prepare_image(img1[None], margin=MARGIN)
    lw1 = gather_level(ai1, xy1_init, cut=not ai1.padded.is_cuda)
    tmpl = _template(lw0, xy0, patch)
    return _lk_dispatch(lw1, tmpl, xy1_init, patch, iters)


def _pyr_track_prepared(ais0, ais1, xy0, xy1_guess, patch, iters,
                        want_bwd: bool, max_residual: float = 25.0):
    """Coarse-to-fine forward LK (K2 at each level), then, with want_bwd,
    the level-0 backward pass. On the card K2 reads the levels in place;
    on the CPU the windows are cut first.

    Returns the KltResult of the forward track, with want_bwd also the
    forward-backward distance."""
    levels = len(ais0)
    cut = not ais0[0].padded.is_cuda
    scale = 2.0 ** (levels - 1)
    p1 = xy1_guess / scale
    lw0_l0 = lw1_l0 = None
    for lv in range(levels - 1, -1, -1):
        p0_lv = xy0 / 2.0 ** lv
        if lv != levels - 1:
            p1 = p1 * 2.0
        lw0 = gather_level(ais0[lv], p0_lv, cut)
        lw1 = gather_level(ais1[lv], p1, cut)
        p1, res, conv = _lk_level(lw0, lw1, p0_lv, p1, patch, iters)
        if lv == 0:
            lw0_l0, lw1_l0 = lw0, lw1
    H, W = ais0[0].shape
    inb = ((p1[:, 0] > 2) & (p1[:, 0] < W - 3)
           & (p1[:, 1] > 2) & (p1[:, 1] < H - 3))
    fwd_ok = conv & inb & (res < max_residual)
    if not want_bwd:
        return KltResult(xy=p1, ok=fwd_ok)
    # backward pass at level 0, reusing the forward windows (or their
    # offsets): template from the img1 window at the forward result,
    # iterate over the img0 window starting at xy0 (flow magnitude <=
    # search radius by construction)
    q, _res_b, conv_b = _lk_level(lw1_l0, lw0_l0, p1, xy0, patch, iters)
    fb = torch.linalg.norm(q - xy0, dim=1)
    return KltResult(xy=p1, ok=fwd_ok & conv_b), fb


def pyr_track(pyr0, pyr1, xy0, xy1_guess, patch: int = 15, iters: int = 10,
              max_residual: float = 25.0):
    """Coarse-to-fine LK over pyramids (sequences of raw level tensors or
    prepared AlignedImages, level 0 = full res), forward only."""
    return _pyr_track_prepared(_as_prepared(pyr0), _as_prepared(pyr1), xy0,
                               xy1_guess, patch, iters, want_bwd=False,
                               max_residual=max_residual)


def forward_backward_track(pyr0, pyr1, xy0, xy1_guess, patch: int = 15,
                           iters: int = 10, fb_thresh: float = 1.0):
    """Forward LK + level-0 reverse consistency gate
    (image_processor.cpp:628-652) over pyramids of raw level tensors or
    prepared AlignedImages (level 0 = full res)."""
    res, fb = _pyr_track_prepared(_as_prepared(pyr0), _as_prepared(pyr1),
                                  xy0, xy1_guess, patch, iters, want_bwd=True)
    return KltResult(xy=res.xy, ok=res.ok & (fb < fb_thresh))


def _as_prepared(pyr):
    if isinstance(pyr[0], AlignedImage):
        return tuple(pyr)
    return prepare_pyramid(pyr)


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
