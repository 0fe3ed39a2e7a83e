"""Shi-Tomasi corner detection with gridded spatial distribution.

Counterpart of ``orcvio_tpu/frontend/detect.py`` (reference: the masked
goodFeaturesToTrack, image_processor.cpp:341,1015-1047): a min-eigenvalue
score map, 3x3 non-maximum suppression, a square suppression zone around
existing features, and the top scores of each grid cell.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import _sep_conv, gradients


def shi_tomasi_score(img, window: int = 3):
    """Min eigenvalue of the structure tensor per pixel."""
    Ix, Iy = gradients(img)
    k = (1.0 / window,) * window
    Sxx = _sep_conv(Ix * Ix, k)
    Syy = _sep_conv(Iy * Iy, k)
    Sxy = _sep_conv(Ix * Iy, k)
    tr = Sxx + Syy
    det = Sxx * Syy - Sxy * Sxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    return tr / 2 - disc


def _max_filter(x, kh: int, kw: int):
    """Max over a centred (kh, kw) window (odd sizes), -inf beyond the edge."""
    return F.max_pool2d(x[None, None], (kh, kw), stride=1,
                        padding=(kh // 2, kw // 2))[0, 0]


def _nms3(score):
    """3x3 non-maximum suppression."""
    m = _max_filter(score, 3, 3)
    return torch.where(score >= m, score, torch.zeros_like(score))


def detect_grid(img, n_per_cell: int, grid_rows: int, grid_cols: int,
                occupied_xy=None, occupied_mask=None, min_distance: float = 20.0,
                quality: float = 0.01, border: int = 8):
    """Detect up to n_per_cell corners per grid cell, avoiding occupied areas.

    occupied_xy: (N, 2) existing feature pixel coords; detections within a
    (2*min_distance+1) square of one are suppressed. Returns (xy (C*n, 2),
    score (C*n,), valid (C*n,)) with C = grid_rows * grid_cols.
    """
    H, W = img.shape
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = _nms3(shi_tomasi_score(img))
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inb = ((yy >= border) & (yy < H - border)
           & (xx >= border) & (xx < W - border))
    score = torch.where(inb, score, zero)
    if occupied_xy is not None:
        ix = torch.clamp(occupied_xy[:, 0].to(torch.int32), 0, W - 1)
        iy = torch.clamp(occupied_xy[:, 1].to(torch.int32), 0, H - 1)
        occ = torch.zeros(H * W, dtype=img.dtype, device=img.device)
        occ = occ.scatter_reduce(0, (iy * W + ix).long(),
                                 occupied_mask.to(img.dtype), reduce="amax")
        k = 2 * int(min_distance) + 1
        occ = _max_filter(_max_filter(occ.reshape(H, W), k, 1), 1, k)
        score = torch.where(occ > 0, zero, score)

    thresh = quality * torch.max(score)
    score = torch.where(score > thresh, score, zero)

    ch = H // grid_rows
    cw = W // grid_cols
    C = grid_rows * grid_cols
    cells = (score[: ch * grid_rows, : cw * grid_cols]
             .reshape(grid_rows, ch, grid_cols, cw)
             .permute(0, 2, 1, 3).reshape(C, ch * cw))
    top_v, top_i = torch.topk(cells, n_per_cell, dim=1)  # (C, n), sorted
    cell = torch.arange(C, device=img.device)[:, None]
    gy = (cell // grid_cols) * ch + top_i // cw
    gx = (cell % grid_cols) * cw + top_i % cw
    xy = torch.stack([gx, gy], dim=-1).reshape(-1, 2).to(img.dtype)
    sc = top_v.reshape(-1)
    return xy, sc, sc > 0.0
