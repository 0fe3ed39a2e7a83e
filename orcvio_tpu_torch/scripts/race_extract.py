"""The window-extraction race, and kernel K5: 64-lane-aligned window extract.

Counterpart of ``scripts/race_extract.py``: N = 200 windows of 36 rows are
cut from each 480x752 frame, edge-padded to (560, 896), over T = 30 frames
at B = 1 and B = 8 images a frame; the race times each variant in us per
extract, the frame's padding included, as the JAX script does.

K5 replaces ``extract_pallas`` (``_gather_kernel``,
``scripts/race_extract.py:86``): a window of 36 rows and 128 lanes at a
lane start rounded down to a multiple of 64, and the logical window's lane
offset in it. On the card it is ``csrc/extract64.cu``, one launch for all
B x N windows (the race's B = 8 vmap). ``extract_dynslice``, the race's
"dynslice" variant, is its plain version: the same windows by advanced
indexing. The race's "rowgather+colonehot" and "full-onehot" variants are
one-hot matrix products for the TPU's matrix unit and are not ported.

Origins are clamped so that every read lies in the image: y to [0, HP -
36], x to [0, WP - 36], and the lane start to [0, WP - 128]. Where the TPU
kernel's reads are in range the clamps change nothing.

    python -m orcvio_tpu_torch.scripts.race_extract [--device cpu] [--frames T]
"""
from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import _build

H, W, N, WD, T = 480, 752, 200, 36, 30
PAD = 40  # edge pad so windows never clip
HP = H + 2 * PAD                          # 560
WP = ((W + 2 * PAD + 127) // 128) * 128   # 896
LANES, ALIGN = 128, 64


def prep(img):
    """Edge-pad (B, H, W) frames to (B, HP, WP): replicate PAD px, then
    zeros on the right to WP."""
    p = F.pad(img, (PAD, PAD, PAD, PAD), mode="replicate")
    return F.pad(p, (0, WP - p.shape[-1]))


def _origins(imgp, oy, ox, wd: int = WD):
    """Clamped row start, 64-aligned lane start and lane offset (B, N)."""
    Hp, Wp = imgp.shape[-2:]
    y = torch.clamp(oy, 0, Hp - wd)
    x = torch.clamp(ox, 0, Wp - wd)
    x64 = torch.clamp(torch.div(x, ALIGN, rounding_mode="floor") * ALIGN,
                      max=Wp - LANES)
    return y, x64, x - x64


def extract_dynslice(imgp, oy, ox):
    """K5's plain version: windows (B, N, WD, 128) of imgp (B, HP, WP) at
    the 64-aligned lane start, and the lane offset (B, N) int32 of the
    logical (WD, WD) window in each, by advanced indexing."""
    y, x64, off = _origins(imgp, oy, ox)
    rows = y.long()[..., None] + torch.arange(WD, device=imgp.device)
    cols = x64.long()[..., None] + torch.arange(LANES, device=imgp.device)
    b = torch.arange(imgp.shape[0], device=imgp.device)[:, None, None, None]
    return imgp[b, rows[..., :, None], cols[..., None, :]], off


def _check_cuda(imgp, oy, ox):
    if imgp.dtype != torch.float32:
        raise TypeError(f"extract64: imgp must be float32, got {imgp.dtype}")
    if imgp.dim() != 3 or not imgp.is_contiguous():
        raise ValueError("extract64: imgp must be a contiguous (B, Hp, Wp)")
    B, Hp, Wp = imgp.shape
    if Wp % 4 or Wp < LANES or Hp < WD or imgp.data_ptr() % 16:
        raise ValueError(f"extract64: image {(Hp, Wp)} must be 16-byte "
                         f"aligned rows of a multiple of 4 lanes, at least "
                         f"({WD}, {LANES})")
    for t in (oy, ox):
        if (t.device != imgp.device or t.dtype != torch.int32
                or t.dim() != 2 or t.shape[0] != B or t.shape != oy.shape
                or not t.is_contiguous()):
            raise ValueError("extract64: oy, ox must be contiguous (B, N) "
                             "int32 tensors on the image's device")


def extract_pallas(imgp, oy, ox):
    """Windows (B, N, WD, 128) of imgp (B, HP, WP) float32 at rows oy and
    64-aligned lane starts floor(ox / 64) * 64, with oy/ox (B, N) int32,
    and the lane offset ox - start (B, N) int32 of each logical window.
    CPU tensors take the plain version; CUDA tensors launch K5 or raise."""
    if imgp.device.type == "cpu":
        return extract_dynslice(imgp, oy, ox)
    if imgp.device.type != "cuda":
        raise ValueError(f"extract64: unsupported device {imgp.device}")
    _check_cuda(imgp, oy, ox)
    B, Hp, Wp = imgp.shape
    n = oy.shape[1]
    out = torch.empty((B, n, WD, LANES), dtype=imgp.dtype, device=imgp.device)
    off = torch.empty((B, n), dtype=torch.int32, device=imgp.device)
    if B == 0 or n == 0:
        return out, off
    lib = _build.library("extract64")
    rc = lib.extract64(
        imgp.data_ptr(), oy.data_ptr(), ox.data_ptr(), out.data_ptr(),
        off.data_ptr(), B, n, Hp, Wp, WD, imgp.device.index,
        torch.cuda.current_stream(imgp.device).cuda_stream)
    if rc:
        raise RuntimeError(f"extract64: CUDA error {rc} at launch")
    extract_pallas.launches += 1
    return out, off


extract_pallas.launches = 0

_build.declare("extract64", "extract64", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

VARIANTS = {"dynslice": extract_dynslice, "pallas64": extract_pallas}


def draws(frames: int = T, seed: int = 0):
    """The race's seeded frames (frames, H, W) float32 and origins oy, ox
    (frames, N) int32, as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (frames, H, W)).astype(np.float32)
    oys = (rng.integers(0, H, (frames, N)) + PAD - WD // 2).astype(np.int32)
    oxs = (rng.integers(0, W, (frames, N)) + PAD - WD // 2).astype(np.int32)
    return imgs, oys, oxs


def bench(name, fn, batch: int, device, frames: int = T, reps: int = 5):
    """us per extract of `fn` over `frames` frames of `batch` images: each
    frame padded, extracted and every window element consumed (a sum of
    squares), as the JAX race's scan step. One untimed pass first. CUDA
    events on the card, the host clock on the CPU."""
    imgs, oys, oxs = (torch.as_tensor(x, device=device) for x in draws(frames))
    imgs, oys, oxs = (x[:, None].repeat(1, batch, *([1] * (x.dim() - 1)))
                      .contiguous() for x in (imgs, oys, oxs))

    def run():
        c = torch.zeros(batch, device=device)
        for k in range(frames):
            w = fn(prep(imgs[k]), oys[k], oxs[k])[0]
            c = c + torch.sum(w * w, dim=(1, 2, 3))
        return c

    run()
    cuda = device.type == "cuda"
    if cuda:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        e0.record()
    else:
        t0 = time.perf_counter()
    for _ in range(reps):
        run()
    if cuda:
        e1.record()
        torch.cuda.synchronize(device)
        ms = e0.elapsed_time(e1)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    us = ms * 1e3 / (reps * frames * batch)
    print(f"{name:12s} B={batch}  {us:8.3f} us/extract-equiv  ({device})",
          flush=True)
    return us


def main(device=None, frames: int = T, reps: int = 5):
    """The race on `device` (the card unless told): every variant at B = 1
    and B = 8. Returns {name: {B: us per extract}}."""
    device = resolve_device(device)
    return {name: {B: bench(name, fn, B, device, frames, reps)
                   for B in (1, 8)}
            for name, fn in VARIANTS.items()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=T)
    args = ap.parse_args()
    main(args.device, args.frames)
