"""Kernels K2 and K3: Lucas-Kanade per feature, one pyramid level a launch.

K2 replaces ``orcvio_tpu/ops/lk_pallas.py:lk_level_fused``
(``_lk_level_kernel``), the main path's fused level. Per feature: a
bilinear (P+2)x(P+2) template patch of win0 at aux[:, 0:2], central
differences inside it (t, tgx, tgy for the P x P taps), the
Hessian a11/a12/a22 and its determinant; then Gauss-Newton steps over win1
from aux[:, 10:12], clamped to [aux[:, 4:6], aux[:, 6:8]], for at most
`iters` steps, stopping once the step norm is at most `eps`; then the mean
absolute residual at the final position.

The TPU kernel stops a whole block of features once all their steps are
below eps; here each feature stops on its own (the TPU kernel's rule at
block_n=1, and cv::TermCriteria's). eps = 0 is the fixed-count loop.

On the card this is ``csrc/lk_level.cu``; on the CPU the plain version
below. Bound on the card: the taps the function needs, not the windows it
is given: per feature a (P+3)^2 block of win0 and, of win1, the union of
the (P+1)^2 blocks at the positions it visits (at most 37x37 at P = 15),
1.3 KB to 6.8 KB against the windows' 98 KB, and some 14 operations per tap
per step on 225 taps. Both come to well under a microsecond for 200
features, so the kernel is latency-bound: one warp per feature (4 a
block), shuffle reductions and no block barrier, and every tap the
feature can reach staged once into shared memory, so that its steps read
nothing else.

The kernel reads each image as (base, row stride, per-feature offset), so
it has two entry points: ``lk_level_fused`` over window tensors (the JAX
package's interface), and ``lk_level_src`` over the padded pyramid levels
themselves, at the offsets of the windows K1 would cut
(``ops/window_gather.py:window_offsets``). Both read the same pixels and
give the same bits; the level route writes no windows and launches no K1.
The staged tile of the second image is SEARCH_TILE pixels square: on the
card a feature whose search bounds [lo, hi] need more gets a NaN row
(a search window S px wide needs S + 1; the tracker's is 36), where the
plain version computes one.

K3 replaces ``lk_iterate_fused`` (``_lk_kernel``), the iterate-only kernel
behind ``frontend/klt.py:_lk_iterate_pallas``: exactly `iters` steps (no
eps stop) over win from a template t, tgx, tgy computed outside and the
Hessian in aux, then the residual. On the card it is K2's kernel body
(``csrc/lk_level.cu``) with the template loaded into registers where K2
builds it, and K2's two sources: ``lk_iterate_fused`` over window tensors,
``lk_iterate_src`` over the padded level read in place, the same bits. It
stages K2's SEARCH_TILE-pixel block, so bounds wider than that give a NaN
row there too.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _vmap

# aux layout per feature (window-local coordinates), K2:
# [p0_x p0_y . . lo_x lo_y hi_x hi_y . . p1_x p1_y . . . .]
# K3 (the template is given, so columns 0-3 hold its Hessian instead):
# [a11 a12 a22 det_safe lo_x lo_y hi_x hi_y . . p_x p_y . . . .]
AUX_W = 16
MAX_PATCH = 31  # largest patch the kernel's shared arrays hold
SEARCH_TILE = 40  # edge of the staged block of the searched image (K2, K3)


def resample(win, lx, ly, P: int):
    """Bilinear (P, P) patches of win (N, R, L) with (0, 0) tap at window
    coordinates (lx, ly), each (N,), clamped so that every tap lies in the
    window. A row lerp, then a column lerp, as the JAX package's CPU branch
    of ``frontend/klt.py:resample`` and the kernel compute it. The one
    sampler of the port: K2's plain version and ORB's patch reads
    (``frontend/klt.py:extract_patches``) both use it."""
    N, R, L = win.shape
    ly = torch.clamp(ly, 0.0, R - 1.001 - P)
    lx = torch.clamp(lx, 0.0, L - 1.001 - P)
    iy = torch.floor(ly)
    ix = torch.floor(lx)
    fy = (ly - iy)[:, None, None]
    fx = (lx - ix)[:, None, None]
    a = torch.arange(P + 1, device=win.device)
    rows = iy.long()[:, None] + a
    cols = ix.long()[:, None] + a
    n = torch.arange(N, device=win.device)[:, None, None]
    sub = win[n, rows[:, :, None], cols[:, None, :]]  # (N, P+1, P+1)
    rws = sub[:, :P] * (1 - fy) + sub[:, 1:] * fy
    return rws[..., :P] * (1 - fx) + rws[..., 1:] * fx


def lk_level_fused_plain(win0, win1, aux, iters: int, patch: int,
                         eps: float = 0.01):
    """Plain PyTorch version, vectorised over features. A feature that has
    stopped keeps its position and its last step norm."""
    P = patch
    r = (P - 1) // 2
    col = lambda j: aux[:, j]  # noqa: E731
    lo_x, lo_y, hi_x, hi_y = col(4), col(5), col(6), col(7)

    tp = resample(win0, col(0) - (r + 1), col(1) - (r + 1), P + 2)
    t = tp[:, 1:-1, 1:-1]
    tgx = 0.5 * (tp[:, 1:-1, 2:] - tp[:, 1:-1, :-2])
    tgy = 0.5 * (tp[:, 2:, 1:-1] - tp[:, :-2, 1:-1])
    a11 = torch.sum(tgx * tgx, dim=(1, 2))
    a12 = torch.sum(tgx * tgy, dim=(1, 2))
    a22 = torch.sum(tgy * tgy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    det_safe = torch.where(det > 1e-6, det, torch.ones_like(det))

    lx = torch.clamp(col(10), lo_x, hi_x)
    ly = torch.clamp(col(11), lo_y, hi_y)
    dn = torch.full_like(lx, float("inf"))
    steps = torch.zeros_like(lx)
    for _ in range(iters):
        active = dn > eps
        steps = steps + active.to(steps.dtype)
        cur = resample(win1, lx - r, ly - r, P)
        err = cur - t
        b1 = torch.sum(tgx * err, dim=(1, 2))
        b2 = torch.sum(tgy * err, dim=(1, 2))
        dx = (a22 * b1 - a12 * b2) / det_safe
        dy = (a11 * b2 - a12 * b1) / det_safe
        lx = torch.where(active, torch.clamp(lx - dx, lo_x, hi_x), lx)
        ly = torch.where(active, torch.clamp(ly - dy, lo_y, hi_y), ly)
        dn = torch.where(active, torch.sqrt(dx * dx + dy * dy), dn)
    cur = resample(win1, lx - r, ly - r, P)
    res = torch.sum(torch.abs(cur - t), dim=(1, 2)) / (P * P)
    z = torch.zeros_like(lx)
    return torch.stack([lx, ly, res, dn, det, steps, z, z], dim=1)


def _check_common(what, win, named, aux, patch, margin):
    """What both LK kernels need: float32 tensors, contiguous on win's
    device, an (N, AUX_W) aux, an odd patch the shared arrays hold, and
    windows (N, R, L) at least patch + margin each way."""
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != win.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{win.device}")
    if win.dim() != 3:
        raise ValueError(f"{what}: windows {tuple(win.shape)} must be "
                         "(N, R, L)")
    N, R, L = win.shape
    if aux.shape != (N, AUX_W):
        raise ValueError(f"{what}: aux must be ({N}, {AUX_W})")
    if not 1 <= patch <= MAX_PATCH or patch % 2 == 0:
        raise ValueError(f"{what}: patch must be odd and <= {MAX_PATCH}")
    if R < patch + margin or L < patch + margin:
        raise ValueError(f"{what}: windows ({R}, {L}) too small for "
                         f"patch {patch}")


def _check_cuda(win0, win1, aux, patch):
    _check_common("lk level", win1,
                  (("win0", win0), ("win1", win1), ("aux", aux)), aux, patch,
                  4)
    if win0.shape != win1.shape:
        raise ValueError(f"lk level: windows {tuple(win0.shape)} and "
                         f"{tuple(win1.shape)} must be one (N, R, L) shape")


def lk_level_fused(win0, win1, aux, iters: int, patch: int,
                   eps: float = 0.01):
    """One pyramid level for all features. Returns (N, 8):
    [lx, ly, mean |I - T|, last step norm, det, steps taken, 0, 0], with
    (lx, ly) in window-local coordinates of win1 (the TPU kernel's row, with
    the step count where it writes 0). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. On the card a feature whose
    search bounds aux[4:8] reach more than SEARCH_TILE pixels of win1 each
    way (a search window over SEARCH_TILE - 1 px wide) gets NaN in columns
    0-4, as the kernel stages a SEARCH_TILE-pixel block per feature;
    frontend/klt.py:_converged reads such a row as not converged."""
    if win1.device.type == "cpu":
        return lk_level_fused_plain(win0, win1, aux, iters, patch, eps)
    if win1.device.type != "cuda":
        raise ValueError(f"lk level: unsupported device {win1.device}")
    _check_cuda(win0, win1, aux, patch)
    N, R, L = win1.shape
    out = torch.empty((N, 8), dtype=win1.dtype, device=win1.device)
    if N == 0:
        return out
    lib = _build.library("lk_level")
    rc = lib.lk_level(
        win0.data_ptr(), win1.data_ptr(), aux.data_ptr(), out.data_ptr(),
        N, R, L, patch, iters, eps, win1.device.index,
        torch.cuda.current_stream(win1.device).cuda_stream)
    if rc:
        raise RuntimeError(f"lk level: CUDA error {rc} at launch")
    lk_level_fused.launches += 1
    return out


lk_level_fused.launches = 0

_build.declare("lk_level", "lk_level", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def cut_windows(img, off, rows: int, lanes: int):
    """(N, rows, lanes) windows of the 2-D img, window n starting at element
    off[n], rows img.shape[-1] elements apart: what lk_level_src reads."""
    stride = img.shape[-1]
    r = torch.arange(rows, device=img.device)[:, None] * stride
    c = torch.arange(lanes, device=img.device)
    return img.reshape(-1)[off[:, None, None] + r + c]


def lk_level_src_plain(img0, off0, img1, off1, aux, iters: int, patch: int,
                       eps: float = 0.01, rows: int = 48, lanes: int = 256):
    """Plain PyTorch version of the level route: the windows cut, then K2's
    plain version."""
    return lk_level_fused_plain(cut_windows(img0, off0, rows, lanes),
                                cut_windows(img1, off1, rows, lanes), aux,
                                iters, patch, eps)


def _check_src_cuda(what, imgs, offs, aux, patch, rows, lanes, margin):
    """What the level routes need: float32 2-D images holding (rows, lanes)
    windows, (N,) int64 offsets, an (N, AUX_W) aux, all contiguous on one
    device, an odd patch the kernel holds, and windows at least patch +
    margin each way. imgs, offs: ((name, tensor), ...)."""
    dev = imgs[0][1].device
    for name, t in (*imgs, ("aux", aux)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    for name, t in (*imgs, *offs, ("aux", aux)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {dev}")
    N = aux.shape[0]
    for name, off in offs:
        if off.dtype != torch.int64 or tuple(off.shape) != (N,):
            raise ValueError(f"{what}: {name} must be ({N},) int64")
    if aux.shape != (N, AUX_W):
        raise ValueError(f"{what}: aux must be ({N}, {AUX_W})")
    if not 1 <= patch <= MAX_PATCH or patch % 2 == 0:
        raise ValueError(f"{what}: patch must be odd and <= {MAX_PATCH}")
    for name, img in imgs:
        if img.dim() != 2 or img.shape[0] < rows or img.shape[1] < lanes:
            raise ValueError(f"{what}: {name} {tuple(img.shape)} must be a "
                             f"2-D image holding ({rows}, {lanes}) windows")
    if rows < patch + margin or lanes < patch + margin:
        raise ValueError(f"{what}: windows ({rows}, {lanes}) too small for "
                         f"patch {patch}")


def lk_level_src(img0, off0, img1, off1, aux, iters: int, patch: int,
                 eps: float = 0.01, rows: int = 48, lanes: int = 256):
    """K2 reading the images in place: the (rows, lanes) window of feature
    n starts at element off_k[n] of the 2-D padded level img_k (rows
    img_k.shape[-1] apart), as ops/window_gather.py:window_offsets gives
    it; aux as lk_level_fused's. Returns lk_level_fused's (N, 8) rows on
    those windows, NaN rows included. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. Under torch.func.vmap a batch
    of calls is one call (one launch) over the B * N features, the rows'
    levels stacked into one image."""
    return _lk_level_src(img0, off0, img1, off1, aux, iters, patch, eps,
                         rows, lanes)


@torch.library.custom_op("orcvio_tpu_torch::lk_level_src", mutates_args=())
def _lk_level_src(img0: torch.Tensor, off0: torch.Tensor, img1: torch.Tensor,
                  off1: torch.Tensor, aux: torch.Tensor, iters: int,
                  patch: int, eps: float, rows: int,
                  lanes: int) -> torch.Tensor:
    if img1.device.type == "cpu":
        return lk_level_src_plain(img0, off0, img1, off1, aux, iters, patch,
                                  eps, rows, lanes)
    if img1.device.type != "cuda":
        raise ValueError(f"lk level: unsupported device {img1.device}")
    _check_src_cuda("lk level (levels)", (("img0", img0), ("img1", img1)),
                    (("off0", off0), ("off1", off1)), aux, patch, rows, lanes,
                    4)
    N = aux.shape[0]
    out = torch.empty((N, 8), dtype=img1.dtype, device=img1.device)
    if N == 0:
        return out
    lib = _build.library("lk_level")
    rc = lib.lk_level_src(
        img0.data_ptr(), off0.data_ptr(), img0.shape[-1], img0.numel(),
        img1.data_ptr(), off1.data_ptr(), img1.shape[-1], img1.numel(),
        aux.data_ptr(), out.data_ptr(), N, rows, lanes, patch, iters, eps,
        img1.device.index, torch.cuda.current_stream(img1.device).cuda_stream)
    if rc:
        raise RuntimeError(f"lk level: CUDA error {rc} at launch")
    lk_level_fused.launches += 1
    return out


@_lk_level_src.register_vmap
def _lk_level_src_vmap(info, in_dims, img0, off0, img1, off1, aux, iters,
                       patch, eps, rows, lanes):
    """B calls as one over B * N features: a batched (B, Hp, Wp) level is
    read as one (B * Hp, Wp) image with row b's offsets shifted by b Hp Wp
    (window_origins keeps every window inside its own image); a shared
    level is read as it is, its offsets unshifted."""
    B = info.batch_size
    srcs = []
    for img, d_img, off, d_off in ((img0, in_dims[0], off0, in_dims[1]),
                                   (img1, in_dims[2], off1, in_dims[3])):
        img, batched = _vmap.split(img, d_img)
        off = _vmap.rows(off, d_off, B)
        if batched:
            off = off + img[0].numel() * torch.arange(
                B, dtype=off.dtype, device=off.device)[:, None]
            img = img.reshape(-1, img.shape[-1]).contiguous()
        srcs += [img, off.reshape(-1).contiguous()]
    aux = _vmap.flat(aux, in_dims[4], B)
    out = _lk_level_src(*srcs, aux, iters, patch, eps, rows, lanes)
    return out.reshape(B, -1, 8), 0


_build.declare("lk_level", "lk_level_src", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p])


def lk_iterate_fused_plain(win, t, tgx, tgy, aux, iters: int, patch: int):
    """Plain PyTorch version of K3, vectorised over features: the fixed-count
    loop of the TPU kernel through the port's one sampler."""
    P = patch
    r = (P - 1) // 2
    col = lambda j: aux[:, j]  # noqa: E731
    a11, a12, a22, det_safe = col(0), col(1), col(2), col(3)
    lo_x, lo_y, hi_x, hi_y = col(4), col(5), col(6), col(7)
    lx = torch.clamp(col(10), lo_x, hi_x)
    ly = torch.clamp(col(11), lo_y, hi_y)
    dn = torch.full_like(lx, float("inf"))
    for _ in range(iters):
        err = resample(win, lx - r, ly - r, P) - t
        b1 = torch.sum(tgx * err, dim=(1, 2))
        b2 = torch.sum(tgy * err, dim=(1, 2))
        dx = (a22 * b1 - a12 * b2) / det_safe
        dy = (a11 * b2 - a12 * b1) / det_safe
        lx = torch.clamp(lx - dx, lo_x, hi_x)
        ly = torch.clamp(ly - dy, lo_y, hi_y)
        dn = torch.sqrt(dx * dx + dy * dy)
    cur = resample(win, lx - r, ly - r, P)
    res = torch.sum(torch.abs(cur - t), dim=(1, 2)) / (P * P)
    z = torch.zeros_like(lx)
    return torch.stack([lx, ly, res, dn, z, z, z, z], dim=1)


def _check_template(what, t, tgx, tgy, N, patch, device):
    for name, x in (("t", t), ("tgx", tgx), ("tgy", tgy)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {x.dtype}")
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {device}")
        if x.shape != (N, patch, patch):
            raise ValueError(f"{what}: {name} must be ({N}, {patch}, "
                             f"{patch}), got {tuple(x.shape)}")


def _launch_iterate(entry, lead, device, t, tgx, tgy, aux, N, rows, lanes,
                    iters, patch):
    """Launch K3 through C entry `entry` of the lk_level library, its
    source arguments `lead` first; count the launch."""
    out = torch.empty((N, 8), dtype=torch.float32, device=device)
    if N == 0:
        return out
    rc = getattr(_build.library("lk_level"), entry)(
        *lead, t.data_ptr(), tgx.data_ptr(), tgy.data_ptr(), aux.data_ptr(),
        out.data_ptr(), N, rows, lanes, patch, iters, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"lk iterate: CUDA error {rc} at launch")
    lk_iterate_fused.launches += 1
    return out


def lk_iterate_fused(win, t, tgx, tgy, aux, iters: int, patch: int):
    """`iters` LK steps for all features over win (N, R, L) from the template
    t, tgx, tgy (N, P, P) and aux (N, AUX_W) in K3's layout. Returns (N, 8):
    [lx, ly, mean |I - T|, last step norm, 0, 0, 0, 0], (lx, ly) in window
    coordinates. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. On the card a feature whose search bounds aux[4:8]
    reach more than SEARCH_TILE pixels of win each way (a search window
    over SEARCH_TILE - 1 px wide) gets NaN in columns 0-3, as the kernel
    stages a SEARCH_TILE-pixel block per feature; frontend/klt.py:_converged
    reads such a row as not converged."""
    if win.device.type == "cpu":
        return lk_iterate_fused_plain(win, t, tgx, tgy, aux, iters, patch)
    if win.device.type != "cuda":
        raise ValueError(f"lk iterate: unsupported device {win.device}")
    _check_common("lk iterate", win, (("win", win), ("aux", aux)), aux,
                  patch, 2)
    N, R, L = win.shape
    _check_template("lk iterate", t, tgx, tgy, N, patch, win.device)
    return _launch_iterate("lk_iterate", (win.data_ptr(),), win.device, t,
                           tgx, tgy, aux, N, R, L, iters, patch)


lk_iterate_fused.launches = 0

_build.declare("lk_level", "lk_iterate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def lk_iterate_src_plain(img, off, t, tgx, tgy, aux, iters: int, patch: int,
                         rows: int = 48, lanes: int = 256):
    """Plain PyTorch version of K3's level route: the windows cut, then
    K3's plain version."""
    return lk_iterate_fused_plain(cut_windows(img, off, rows, lanes), t, tgx,
                                  tgy, aux, iters, patch)


def lk_iterate_src(img, off, t, tgx, tgy, aux, iters: int, patch: int,
                   rows: int = 48, lanes: int = 256):
    """K3 reading the image in place: the (rows, lanes) window of feature n
    starts at element off[n] of the 2-D padded level img (rows
    img.shape[-1] apart), as ops/window_gather.py:window_offsets gives it;
    t, tgx, tgy and aux as lk_iterate_fused's. Returns lk_iterate_fused's
    (N, 8) rows on those windows, the NaN rows for search bounds wider than
    SEARCH_TILE included. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if img.device.type == "cpu":
        return lk_iterate_src_plain(img, off, t, tgx, tgy, aux, iters, patch,
                                    rows, lanes)
    if img.device.type != "cuda":
        raise ValueError(f"lk iterate: unsupported device {img.device}")
    _check_src_cuda("lk iterate (level)", (("img", img),), (("off", off),),
                    aux, patch, rows, lanes, 2)
    N = aux.shape[0]
    _check_template("lk iterate (level)", t, tgx, tgy, N, patch, img.device)
    return _launch_iterate(
        "lk_iterate_src", (img.data_ptr(), off.data_ptr(), img.shape[-1],
                           img.numel()), img.device, t, tgx, tgy, aux, N,
        rows, lanes, iters, patch)


_build.declare("lk_level", "lk_iterate_src", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
