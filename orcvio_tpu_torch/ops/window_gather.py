"""Per-feature window extraction from edge-padded, tile-aligned images.

Counterpart of ``orcvio_tpu/ops/window_gather.py``. Windows start on
(8, 128) tile boundaries, as the JAX package's "dma" path gathers them, so
windows and origins match the JAX package one for one. The copy itself is
kernel K1 (``ops/dma_gather.py``): CUDA on the card, a plain slice on the
CPU. ``window_offsets`` gives each window's element offset in the padded
image instead, for K2's level route, which reads the windows in place.
The one-hot matmul gathers and ``crop_lanes`` exist only for the TPU's
matrix unit and are not ported.

Reference contract: the per-feature window reads of
cv::calcOpticalFlowPyrLK / cv::getRectSubPix (image_processor.cpp:568,628)
and the ORB descriptor's patch reads (ORBDescriptor.cpp).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..tree import Tree
from .dma_gather import BL, BR, dma_gather_tiles


@dataclass
class AlignedImage(Tree):
    """Edge-padded, tile-aligned image prepared for window gathering."""
    _static = ("hb", "wb", "pad", "shape")

    padded: torch.Tensor  # (C, Hp, Wp)
    hb: int
    wb: int
    pad: int
    shape: tuple  # original (H, W)


def prepare_image(imgs, margin: int = 40) -> AlignedImage:
    """Edge-pad imgs (C, H, W) by `margin` and on to whole (8, 128) tiles
    (at least two tiles wide). Do this once per image per frame."""
    C, H, W = imgs.shape
    Hp = -(-(H + 2 * margin) // BR) * BR
    Wp = max(-(-(W + 2 * margin) // BL) * BL, 2 * BL)
    p = F.pad(imgs, (margin, Wp - W - margin, margin, Hp - H - margin),
              mode="replicate")
    return AlignedImage(p, Hp // BR, Wp // BL, margin, (H, W))


def _window_blocks(ai: AlignedImage, centers, t0: int):
    """Padded-image (row, col) of each logical window's start, for a window
    starting at floor(clamped center) + t0."""
    H, W = ai.shape
    cf = torch.floor(centers)
    cy = torch.clamp(cf[:, 1], 0, H - 1)
    cx = torch.clamp(cf[:, 0], 0, W - 1)
    oy = cy.to(torch.int32) + (t0 + ai.pad)
    ox = cx.to(torch.int32) + (t0 + ai.pad)
    return oy, ox


def window_origins(ai: AlignedImage, centers, t0: int, rows: int,
                   lanes: int):
    """Tile origins (r0, c0), int32 in units of (8, 128), of the aligned
    windows gather_windows cuts, and their origin (N, 2) float xy in
    original image coords."""
    oy, ox = _window_blocks(ai, centers, t0)
    r0 = torch.clamp(torch.div(oy, BR, rounding_mode="floor"), 0,
                     ai.hb - rows // BR)
    c0 = torch.clamp(torch.div(ox, BL, rounding_mode="floor"), 0,
                     ai.wb - lanes // BL)
    origin = torch.stack([(c0 * BL - ai.pad).to(centers.dtype),
                          (r0 * BR - ai.pad).to(centers.dtype)], dim=1)
    return r0, c0, origin


def window_offsets(ai: AlignedImage, r0, c0):
    """(N,) int64 element offset in ai.padded[c] of each window's (0, 0)
    pixel, for the tile origins window_origins gives; rows lie
    ai.padded.shape[-1] elements apart. Windows read in place at these
    offsets are exactly the windows gather_windows cuts."""
    Wp = ai.padded.shape[-1]
    # int32 arithmetic (offsets stay far below 2**31), widened once
    return torch.add(c0 * BL, r0, alpha=BR * Wp).long()


def gather_windows(ai: AlignedImage, centers, t0: int, wd: int,
                   rows: int, lanes: int):
    """Extract per-feature aligned windows covering [floor(c)+t0, +wd).

    centers: (N, 2) float xy in original image coords. Each returned window
    starts at the enclosing (8, 128) tile boundary, so the logical window
    sits at a per-feature offset inside it.

    Returns (windows (C, N, rows, lanes) in centers.dtype, origin (N, 2)
    float xy of windows[..., 0, 0] in original image coords).
    """
    assert rows % BR == 0 and lanes % BL == 0
    assert rows >= wd + BR - 1, (rows, wd)
    assert lanes >= wd + BL - 1, (lanes, wd)
    r0, c0, origin = window_origins(ai, centers, t0, rows, lanes)
    bidx = torch.zeros_like(r0)
    out = torch.stack([
        dma_gather_tiles(ai.padded[c:c + 1], r0, c0, bidx, rows // BR,
                         lanes // BL)
        for c in range(ai.padded.shape[0])
    ])
    return out.to(centers.dtype), origin
