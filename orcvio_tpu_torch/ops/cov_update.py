"""Kernel K4: the EKF covariance update sym(P - K (H P)).

Replaces ``orcvio_tpu/ops/cov_update.py:cov_update_pallas`` (``_cov_kernel``),
the TPU kernel that forms each output tile of 0.5 (A + A^T) with
A = (I - K H) P directly. The port's ``filter/update.py:apply_ekf_update``
computes the covariance step of every EKF update through it: the stacked
hybrid update, the ZUPT update and the last-chance update.

On the card this is ``csrc/cov_update.cu`` (float32 on the main path, and a
float64 instance); on the CPU the plain version below. HP = H P is an
input: ``apply_ekf_update`` forms it for S and K before this step, so the
kernel does the K HP products and the symmetrization. Bound on the card:
operations, 2 D^2 q FLOP on (2 D^2 + 2 D q) elements with HP given. The
kernel walks the upper triangle of 32x32 tile pairs, runs the products on
the FP64 tensor cores (DMMA; f32 inputs widened exactly, one rounding at
the end), splits q over a cluster of up to 4 CTAs reduced through
distributed shared memory, and stores one value at (i, j) and (j, i), so
the output is exactly symmetric; where q <= 32 (the ZUPT update) a small
kernel of f64 sums over every 16x16 tile takes its place (see the
source's note).

The nb entry serves the Schmidt update: the entries whose row and column
are both >= nb (the nuisance block P_nn) keep P's value, sym(P)_nn, which
is P_nn itself for a symmetric P; the others are sym(P - K HP) as
without it. The kernel skips the products of the tiles wholly inside
that block and masks the entries of a tile that straddles nb.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _vmap


def cov_update_plain(P, K, H, HP=None, nb=None):
    """Plain PyTorch version: P - K @ (H @ P), symmetrized. HP, where given,
    is H @ P already computed; where nb < D, P[nb:, nb:] is kept before the
    symmetrization. Leading batch axes broadcast."""
    A = P - K @ (H @ P if HP is None else HP)
    if nb is not None and nb < P.shape[-1]:
        kept = torch.arange(P.shape[-1], device=P.device) >= nb
        A = torch.where(kept[:, None] & kept[None, :], P, A)
    return 0.5 * (A + A.mT)


def _rows_contiguous(t):
    """t (D1, D2), or each row of t (B, D1, D2), contiguous."""
    return (t if t.dim() == 2 else t[0]).is_contiguous()


def _check_cuda(P, K, HP):
    """P (.., D, D), K (.., D, q), HP (.., q, D), each row contiguous."""
    if P.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cov update: P must be float32 or float64, got {P.dtype}")
    D, q = K.shape[-2:]
    for name, t, shape in (("P", P, (D, D)), ("K", K, (D, q)), ("HP", HP, (q, D))):
        if (t.dtype != P.dtype or t.device != P.device
                or tuple(t.shape[-2:]) != shape or not _rows_contiguous(t)):
            raise ValueError(f"cov update: {name} must be a contiguous {shape} "
                             f"{P.dtype} tensor on {P.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def cov_update(P, K, H, HP=None, nb=None):
    """sym(P - K H P) for P (D, D), K (D, q), H (q, D); HP = H @ P where the
    caller has it; the block [nb:, nb:] kept where nb (default D) is given.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Under torch.func.vmap a batch of calls is one launch of the
    batched entry, a grid over the rows."""
    D = P.shape[0]
    nb = D if nb is None else int(nb)
    if not 0 <= nb <= D:
        raise ValueError(f"cov update: nb must lie in [0, {D}], got {nb}")
    if P.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cov update: unsupported device {P.device}")
    return _cov_update(P, K, H @ P if HP is None else HP, nb)


def _launch(P, K, HP, nb, B=None, strides=None):
    """One launch: the single entry, or with B the batched entry over B
    rows, `strides` the (P, K, HP) elements between rows (0 for an operand
    the rows share)."""
    _check_cuda(P, K, HP)
    D, q = K.shape[-2:]
    out = torch.empty((D, D) if B is None else (B, D, D), dtype=P.dtype,
                      device=P.device)
    lib = _build.library("cov_update")
    f32 = P.dtype == torch.float32
    if B is None:
        entry, batch = (lib.cov_update_f32 if f32 else lib.cov_update_f64), ()
    else:
        entry = lib.cov_update_batched_f32 if f32 else lib.cov_update_batched_f64
        batch = (B, *strides)
    rc = entry(P.data_ptr(), K.data_ptr(), HP.data_ptr(), out.data_ptr(), D,
               q, nb, *batch, P.device.index,
               torch.cuda.current_stream(P.device).cuda_stream)
    if rc:
        raise RuntimeError(f"cov update: CUDA error {rc} at launch")
    cov_update.launches += 1
    return out


@torch.library.custom_op("orcvio_tpu_torch::cov_update", mutates_args=())
def _cov_update(P: torch.Tensor, K: torch.Tensor, HP: torch.Tensor,
                nb: int) -> torch.Tensor:
    if P.device.type == "cpu":
        return cov_update_plain(P, K, None, HP, nb)
    return _launch(P, K.contiguous(), HP.contiguous(), nb)


@_cov_update.register_vmap
def _cov_update_vmap(info, in_dims, P, K, HP, nb):
    """B calls as one launch: each operand's rows reached through its batch
    stride, 0 for one the rows share (never expanded into a copy)."""
    B = info.batch_size
    args, strides = [], []
    for x, d in ((P, in_dims[0]), (K, in_dims[1]), (HP, in_dims[2])):
        x, batched = _vmap.split(x, d)
        if not _rows_contiguous(x):
            x = x.contiguous()
        args.append(x)
        strides.append(x.stride(0) if batched else 0)
    if P.device.type == "cpu":
        P, K, HP = (x if s else x.expand(B, *x.shape)
                    for x, s in zip(args, strides))
        return cov_update_plain(P, K, None, HP, nb), 0
    return _launch(*args, nb, B, strides), 0


cov_update.launches = 0

for _fn in ("cov_update_f32", "cov_update_f64"):
    _build.declare("cov_update", _fn, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
for _fn in ("cov_update_batched_f32", "cov_update_batched_f64"):
    _build.declare("cov_update", _fn, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p])
