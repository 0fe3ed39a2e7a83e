"""Kernel K1: per-feature window gather, an exact copy of tile-aligned windows.

Replaces ``orcvio_tpu/ops/dma_gather.py:dma_gather_tiles`` (``_dma_kernel``),
the TPU kernel that issues one asynchronous HBM->VMEM copy per window.

    out[n] = imgs[bidx[n], 8*r0[n] : 8*(r0[n]+nr), 128*c0[n] : 128*(c0[n]+nl)]

On the card this is ``csrc/window_gather.cu``; on the CPU the plain version
below. Bound on the card: bytes. It does no arithmetic; it must read the
image tiles the windows cover, once each (neighbouring windows share
tiles), and write N*rows*lanes*4 bytes. The kernel copies with 16-byte
loads and stores, one block per (window, 8-row group), neighbouring threads
on neighbouring addresses; a tile shared by several windows is read once per
window, from L2 after the first. On the main path K1 cuts only ORB's
windows: K2 reads the KLT windows in place in the pyramid levels
(``ops/lk_pallas.py:lk_level_src``), so they never reach device memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _vmap

BR, BL = 8, 128  # window origin alignment (rows, lanes), as on the TPU


def dma_gather_tiles_plain(imgs, r0, c0, bidx, nr: int, nl: int):
    """Plain PyTorch version: one indexed gather of every window, with no
    host read. Indices are clamped in range, as the kernel clamps them."""
    B, Hp, Wp = imgs.shape
    rows = torch.arange(nr * BR, device=imgs.device)
    lanes = torch.arange(nl * BL, device=imgs.device)
    r = torch.clamp(r0.long(), 0, Hp // BR - nr)[:, None] * BR + rows
    c = torch.clamp(c0.long(), 0, Wp // BL - nl)[:, None] * BL + lanes
    b = torch.clamp(bidx.long(), 0, B - 1)
    return imgs[b[:, None, None], r[:, :, None], c[:, None, :]]


def _check_cuda(imgs, idx, nr, nl):
    if imgs.dtype != torch.float32:
        raise TypeError(f"window gather: imgs must be float32, got {imgs.dtype}")
    if imgs.dim() != 3 or not imgs.is_contiguous():
        raise ValueError("window gather: imgs must be a contiguous (B, Hp, Wp)")
    B, Hp, Wp = imgs.shape
    if Hp % BR or Wp % BL or Hp < nr * BR or Wp < nl * BL:
        raise ValueError(f"window gather: image {(Hp, Wp)} is not tile-aligned "
                         f"or is smaller than ({nr}*{BR}, {nl}*{BL})")
    if imgs.data_ptr() % 16:
        raise ValueError("window gather: imgs must be 16-byte aligned")
    n = idx[0].shape
    for t in idx:
        if (t.device != imgs.device or t.dtype != torch.int32 or t.dim() != 1
                or t.shape != n or not t.is_contiguous()):
            raise ValueError("window gather: r0, c0, bidx must be contiguous "
                             "(N,) int32 tensors on the images' device")


def dma_gather_tiles(imgs, r0, c0, bidx, nr: int, nl: int):
    """Gather (N, nr*8, nl*128) windows from (B, Hp, Wp) tile-aligned images.

    r0/c0: (N,) int32 window origins in units of 8 rows / 128 lanes; bidx:
    (N,) int32 image index of each window. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. Under torch.func.vmap
    a batch of calls is one call (one launch) over the rows' images
    stacked, each row's image index shifted to its own."""
    return _window_gather(imgs, r0, c0, bidx, nr, nl)


@torch.library.custom_op("orcvio_tpu_torch::window_gather", mutates_args=())
def _window_gather(imgs: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                   bidx: torch.Tensor, nr: int, nl: int) -> torch.Tensor:
    if imgs.device.type == "cpu":
        return dma_gather_tiles_plain(imgs, r0, c0, bidx, nr, nl)
    if imgs.device.type != "cuda":
        raise ValueError(f"window gather: unsupported device {imgs.device}")
    _check_cuda(imgs, (r0, c0, bidx), nr, nl)
    B, Hp, Wp = imgs.shape
    N = r0.shape[0]
    out = torch.empty((N, nr * BR, nl * BL), dtype=imgs.dtype,
                      device=imgs.device)
    if N == 0:
        return out
    lib = _build.library("window_gather")
    rc = lib.window_gather(
        imgs.data_ptr(), r0.data_ptr(), c0.data_ptr(), bidx.data_ptr(),
        out.data_ptr(), N, B, Hp, Wp, nr, nl, imgs.device.index,
        torch.cuda.current_stream(imgs.device).cuda_stream)
    if rc:
        raise RuntimeError(f"window gather: CUDA error {rc} at launch")
    dma_gather_tiles.launches += 1
    return out


@_window_gather.register_vmap
def _window_gather_vmap(info, in_dims, imgs, r0, c0, bidx, nr, nl):
    """B calls as one: the rows' (C, Hp, Wp) images as (B*C, Hp, Wp), row
    b's image indices clamped to its own C images and shifted by b*C. A
    shared stack of images is read as it is."""
    B = info.batch_size
    imgs, batched = _vmap.split(imgs, in_dims[0])
    b = torch.clamp(_vmap.rows(bidx, in_dims[3], B), 0, imgs.shape[-3] - 1)
    if batched:
        C = imgs.shape[1]
        imgs = imgs.reshape(B * C, *imgs.shape[2:]).contiguous()
        b = b + C * torch.arange(B, dtype=b.dtype, device=b.device)[:, None]
    N = b.shape[1]
    out = _window_gather(imgs, _vmap.flat(r0, in_dims[1], B),
                         _vmap.flat(c0, in_dims[2], B), b.reshape(-1), nr, nl)
    return out.reshape(B, N, *out.shape[1:]), 0


dma_gather_tiles.launches = 0

_build.declare("window_gather", "window_gather", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
