"""Kernel K6: the triangulation's Levenberg-Marquardt loop in one launch.

Replaces no TPU kernel: the JAX package's triangulation
(``orcvio_tpu/filter/triangulation.py:triangulate``) is plain jnp, which
XLA fuses. Run eagerly, the same loop of ``tri_max_iters`` damped
Gauss-Newton steps over 3-vectors, each with a Cramer solve written as some
50 elementwise ops, makes some 925 small launches a call. Every
triangulation of the port comes here through
``filter/triangulation.py:triangulate``: the filter's candidates and its
last-chance tracks, and the object layer's keypoints (with a prior point).

On the card this is ``csrc/triangulate.cu``; on the CPU the plain version
below, which the CPU tests hold against the JAX package. Both routes take
float32 and float64 tensors and compute in float64 (float32 inputs
widened exactly, the outputs rounded once at the end), as K4 sums in
float64: where the parallax is nil (a static start) float32 arithmetic
leaves the loop's answer to rounding, and the float32 filter promoted
such features until its covariance went to NaN. Bound on the card:
operations, about 8 kFLOP a feature of 6 observations at 10 steps
(``chip_smoke.py:k6_ops``), some 0.13 GFLOP for the fleet's 1024 x 32
features of 0-6 observations (4 us at 34 TFLOP/s of float64 outside the
tensor cores) against 2.9 us of bytes. The kernel runs one thread a
feature with every 3-vector in registers and follows the plain version's
order of operations (see the source's note); the two agree to rounding.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._C._functorch import is_batchedtensor

from . import _build, _vmap


def solve3(A, b):
    """Batched 3x3 Cramer solve."""
    def e(i, j):
        return A[..., i, j]

    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c01 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c02 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    det = e(0, 0) * c00 + e(0, 1) * c01 + e(0, 2) * c02
    det = torch.where(torch.abs(det) > 1e-18, det, 1e-18)
    adj = torch.stack([
        torch.stack([c00, e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
                     e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)], -1),
        torch.stack([c01, e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
                     e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)], -1),
        torch.stack([c02, e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
                     e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)], -1),
    ], dim=-2)
    return torch.einsum("...ij,...j->...i", adj, b) / det[..., None]


def triangulate_plain(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world,
                      huber: float, iters: int, damping: float):
    """Plain PyTorch version over F compacted tracks: uv (F, T, 2), mask
    (F, T), slot (F, T) clone slots in [0, S), n_obs (F,), camera poses
    R_c2w (S, 3, 3) and t_c_w (S, 3), p_init_world (F, 3) or None.

    Returns (p_anchor, p_world, anchor_slot, valid, inv_param), as
    ``filter/triangulation.py:TriResult``. Computes in the tensors' type:
    the op's CPU route widens float32 to float64 first, as the kernel
    does."""
    dtype = uv.dtype
    Rg, tg = R_c2w[slot], t_c_w[slot]  # (F, T, 3, 3), (F, T, 3)
    a = torch.clamp(n_obs.long() - 1, min=0)

    def take_at(x):  # x[f, a[f]] over the compact axis 1
        return torch.take_along_dim(
            x, a.reshape((-1,) + (1,) * (x.dim() - 1)), dim=1)[:, 0]

    R_a = take_at(Rg)  # (F, 3, 3)
    t_a = take_at(tg)  # (F, 3)

    # relative poses anchor -> camera_t
    R_rel = torch.einsum("ftji,fjk->ftik", Rg, R_a)
    t_rel = torch.einsum("ftji,ftj->fti", Rg, t_a[:, None, :] - tg)

    # two-view initial guess in the anchor frame (feature.hpp:331)
    z_anchor = take_at(uv)
    z_first = uv[:, 0]
    R_fa = R_rel[:, 0]
    t_fa = t_rel[:, 0]
    m = torch.einsum("fij,fj->fi", R_fa, torch.cat(
        [z_anchor, torch.ones_like(z_anchor[:, :1])], 1))
    A0 = m[:, 0] - z_first[:, 0] * m[:, 2]
    A1 = m[:, 1] - z_first[:, 1] * m[:, 2]
    b0 = z_first[:, 0] * t_fa[:, 2] - t_fa[:, 0]
    b1 = z_first[:, 1] * t_fa[:, 2] - t_fa[:, 1]
    denom = A0 * A0 + A1 * A1
    depth = torch.where(denom > 1e-12,
                        (A0 * b0 + A1 * b1) / torch.clamp(denom, min=1e-12), 1.0)
    depth = torch.clamp(depth, 0.1, 1e3)
    if p_init_world is not None:
        h_a = torch.einsum("fji,fj->fi", R_a, p_init_world - t_a)
        prior_ok = torch.all(torch.isfinite(p_init_world), dim=1) & \
            (h_a[:, 2] > 0.2)
        depth = torch.where(prior_ok, torch.clamp(h_a[:, 2], 0.2, 1e3), depth)
    x0 = torch.stack([z_anchor[:, 0], z_anchor[:, 1], 1.0 / depth], dim=1)

    W = torch.cat([R_rel[..., :2], t_rel[..., None]], dim=-1)  # (F, T, 3, 3)

    def residuals(x):
        ab1 = torch.cat([x[:, :2], torch.ones_like(x[:, :1])], dim=1)
        h = torch.einsum("ftij,fj->fti", R_rel, ab1) + x[:, 2:3, None] * t_rel
        r = h[..., :2] / h[..., 2:3] - uv
        return h, torch.where(mask[..., None], r, 0.0)

    eye3 = torch.eye(3, dtype=dtype, device=x0.device)
    x = x0
    lam = torch.full_like(x0[:, 0], damping)
    h, r = residuals(x0)
    cost = torch.sum(r * r, dim=(1, 2))
    for _ in range(iters):
        h3 = h[..., 2:3]
        J = (W[..., :2, :] / h3[..., None]
             - (h[..., :2, None] * W[..., 2:3, :]) / (h3[..., None] ** 2))
        J = torch.where(mask[..., None, None], J, 0.0)
        e = torch.linalg.norm(r, dim=-1)
        w2 = torch.where(e <= huber, 1.0,
                         2.0 * huber / torch.clamp(e, min=1e-12))
        Jw = J * w2[..., None, None]
        A = torch.einsum("ftik,ftil->fkl", Jw, J) + lam[:, None, None] * eye3
        b = torch.einsum("ftik,fti->fk", Jw, r)
        x_new = x - solve3(A, b)
        h_new, r_new = residuals(x_new)
        cost_new = torch.sum(r_new * r_new, dim=(1, 2))
        accept = cost_new < cost
        x = torch.where(accept[:, None], x_new, x)
        cost = torch.where(accept, cost_new, cost)
        h = torch.where(accept[:, None, None], h_new, h)
        r = torch.where(accept[:, None, None], r_new, r)
        lam = torch.where(accept, torch.clamp(lam / 10, min=1e-10),
                          torch.clamp(lam * 10, max=1e12))

    # validity checks (feature.hpp:688-720)
    rho_safe = torch.where(torch.abs(x[:, 2]) > 1e-8, x[:, 2], 1e-8)
    p_anchor = torch.stack([x[:, 0] / rho_safe, x[:, 1] / rho_safe,
                            1.0 / rho_safe], dim=1)
    h, _ = residuals(x)
    depth_all = torch.where(mask, h[..., 2] / rho_safe[:, None], 1.0)
    pos_depth = torch.all(depth_all > 0, dim=1) & (x[:, 2] > 0)
    normalized_cost = cost / torch.clamp(2.0 * n_obs * n_obs, min=1.0)
    cost_ok = normalized_cost < 4.7673e-4  # cost_threshold (feature.hpp:58)
    p0 = torch.stack([x0[:, 0] / x0[:, 2], x0[:, 1] / x0[:, 2], 1.0 / x0[:, 2]],
                     dim=1)
    dist_ok = torch.linalg.norm(p_anchor - p0, dim=1) < 5.0
    valid = pos_depth & cost_ok & dist_ok & (n_obs >= 2)

    p_world = torch.einsum("fij,fj->fi", R_a, p_anchor) + t_a
    return p_anchor, p_world, take_at(slot), valid, x


def triangulate(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world=None, *,
                huber: float, iters: int, damping: float):
    """Triangulate F compacted tracks (the arguments as
    ``triangulate_plain``'s). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. Under torch.func.vmap a batch of
    calls is one call, one launch over every row's features."""
    rows = (uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world)
    out = _triangulate(*(None if x is None else x[None] for x in rows),
                       float(huber), int(iters), float(damping))
    return tuple(x[0] for x in out)


def _plain_rows(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world, huber,
                iters, damping):
    """The plain version over B rows at once: the rows' features joined on
    one axis, each row's slots shifted to its own cameras; float32 inputs
    widened to float64 and the outputs rounded back, as in the kernel."""
    B, F, T = mask.shape
    S = R_c2w.shape[1]
    dtype = uv.dtype

    def wide(x):
        return None if x is None else x.to(torch.float64)

    off = S * torch.arange(B, dtype=slot.dtype, device=slot.device)[:, None]
    out = triangulate_plain(
        wide(uv).reshape(B * F, T, 2), mask.reshape(B * F, T),
        (slot + off[..., None]).reshape(B * F, T), n_obs.reshape(B * F),
        wide(R_c2w).reshape(B * S, 3, 3), wide(t_c_w).reshape(B * S, 3),
        None if p_init_world is None
        else wide(p_init_world).reshape(B * F, 3),
        huber, iters, damping)
    p_anchor, p_world, anchor_slot, valid, inv_param = (
        x.reshape(B, F, *x.shape[1:]) for x in out)
    return (p_anchor.to(dtype), p_world.to(dtype), anchor_slot - off, valid,
            inv_param.to(dtype))


def _row_stride(x):
    """(x with its row x[0] contiguous, elements between rows: 0 where
    every row is row 0)."""
    if x.shape[0] == 1 or x.stride(0) == 0:
        return (x if x[0].is_contiguous() else x[:1].contiguous()), 0
    x = x if x[0].is_contiguous() else x.contiguous()
    return x, x.stride(0)


def _check_cuda(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world):
    """B rows of F tracks of T observations over S cameras, on one card."""
    if uv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"triangulate: uv must be float32 or float64, got "
                        f"{uv.dtype}")
    B, F, T = mask.shape
    S = R_c2w.shape[1] if R_c2w.dim() == 4 else -1
    want = {"uv": (uv, uv.dtype, (B, F, T, 2)),
            "mask": (mask, torch.bool, (B, F, T)),
            "slot": (slot, torch.int64, (B, F, T)),
            "n_obs": (n_obs, torch.int32, (B, F)),
            "R_c2w": (R_c2w, uv.dtype, (B, S, 3, 3)),
            "t_c_w": (t_c_w, uv.dtype, (B, S, 3))}
    if p_init_world is not None:
        want["p_init_world"] = (p_init_world, uv.dtype, (B, F, 3))
    for name, (x, dtype, shape) in want.items():
        if (x.dtype != dtype or x.device != uv.device
                or tuple(x.shape) != shape):
            raise ValueError(f"triangulate: {name} must be a {shape} {dtype} "
                             f"tensor on {uv.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if T < 1 or S < 1:
        raise ValueError(f"triangulate: needs T >= 1 observations and S >= 1 "
                         f"cameras, got T = {T}, S = {S}")


def _launch(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world, huber, iters,
            damping):
    """One launch over B rows: each input's rows reached through its batch
    stride, 0 for one the rows share."""
    _check_cuda(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world)
    B, F, T = mask.shape
    new = lambda *shape, dtype=uv.dtype: torch.empty(  # noqa: E731
        (B, F, *shape), dtype=dtype, device=uv.device)
    out = (new(3), new(3), new(dtype=torch.int64), new(dtype=torch.bool),
           new(3))
    if B * F == 0:
        return out
    ins, strides = [], []
    for x in (uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world):
        x, s = (None, 0) if x is None else _row_stride(x)
        ins.append(x)
        strides.append(s)
    lib = _build.library("triangulate")
    entry = (lib.triangulate_f32 if uv.dtype == torch.float32
             else lib.triangulate_f64)
    rc = entry(*(0 if x is None else x.data_ptr() for x in ins),
               *(x.data_ptr() for x in out), *strides, B, F, T,
               R_c2w.shape[1], huber, iters, damping, uv.device.index,
               torch.cuda.current_stream(uv.device).cuda_stream)
    if rc:
        raise RuntimeError(f"triangulate: CUDA error {rc} at launch")
    triangulate.launches += 1
    return out


@torch.library.custom_op("orcvio_tpu_torch::triangulate", mutates_args=())
def _triangulate(
        uv: torch.Tensor, mask: torch.Tensor, slot: torch.Tensor,
        n_obs: torch.Tensor, R_c2w: torch.Tensor, t_c_w: torch.Tensor,
        p_init_world: Optional[torch.Tensor], huber: float, iters: int,
        damping: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor]:
    """B rows at once: every tensor with a leading axis of B rows."""
    return _rows(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world, huber,
                 iters, damping)


def _rows(uv, *args):
    """The op's body: the plain version on the CPU, the kernel on a card."""
    if uv.device.type == "cpu":
        return _plain_rows(uv, *args)
    if uv.device.type != "cuda":
        raise ValueError(f"triangulate: unsupported device {uv.device}")
    return _launch(uv, *args)


@_triangulate.register_vmap
def _triangulate_vmap(info, in_dims, uv, mask, slot, n_obs, R_c2w, t_c_w,
                      p_init_world, huber, iters, damping):
    """V calls of B rows as one call of V * B rows. An input the calls
    share is expanded without a copy where B is 1 (the kernel reads it
    through a batch stride of 0). Under a vmap outside this one the joined
    rows are still batched and go to the op at that level; else the body
    runs here, as K4's rule runs its kernel, which keeps the op's first
    dispatch (it imports torch._dynamo and sympy, seconds of set-up) out of
    the batched path."""
    V = info.batch_size

    def joined(x, d):
        if x is None:
            return None
        x = _vmap.rows(x, d, V)
        return x.reshape(V * x.shape[1], *x.shape[2:])

    ins = [joined(x, d) for x, d in zip(
        (uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world), in_dims)]
    outer = any(x is not None and is_batchedtensor(x) for x in ins)
    out = (_triangulate if outer else _rows)(*ins, huber, iters, damping)
    return tuple(x.reshape(V, -1, *x.shape[1:]) for x in out), (0,) * 5


triangulate.launches = 0

for _fn in ("triangulate_f32", "triangulate_f64"):
    _build.declare("triangulate", _fn, [
        *[ctypes.c_void_p] * 12, *[ctypes.c_longlong] * 7,
        *[ctypes.c_int] * 4, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p])
