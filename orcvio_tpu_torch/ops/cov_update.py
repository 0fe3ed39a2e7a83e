"""Kernel K4: the EKF covariance update sym(P - K (H P)).

Replaces ``orcvio_tpu/ops/cov_update.py:cov_update_pallas`` (``_cov_kernel``),
the TPU kernel that forms each output tile of 0.5 (A + A^T) with
A = (I - K H) P directly. The port's ``filter/update.py:apply_ekf_update``
computes the covariance step of every EKF update through it: the stacked
hybrid update, the ZUPT update and the last-chance update.

On the card this is ``csrc/cov_update.cu`` (float32 on the main path, and a
float64 instance); on the CPU the plain version below. HP = H P stays a
torch.matmul, as it stays outside the TPU kernel. Bound on the card:
operations, 4 D^2 q FLOP on (2 D^2 + 2 D q) elements. The kernel runs FP32
(or FP64) FMAs, one 16x16 output tile per block, and is exactly symmetric
(see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def cov_update_plain(P, K, H, HP=None):
    """Plain PyTorch version: P - K @ (H @ P), symmetrized. HP, where given,
    is H @ P already computed."""
    A = P - K @ (H @ P if HP is None else HP)
    return 0.5 * (A + A.T)


def _check_cuda(P, K, HP):
    if P.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cov update: P must be float32 or float64, got {P.dtype}")
    D, q = K.shape
    for name, t, shape in (("P", P, (D, D)), ("K", K, (D, q)), ("HP", HP, (q, D))):
        if (t.dtype != P.dtype or t.device != P.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"cov update: {name} must be a contiguous {shape} "
                             f"{P.dtype} tensor on {P.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def cov_update(P, K, H, HP=None):
    """sym(P - K H P) for P (D, D), K (D, q), H (q, D); HP = H @ P where the
    caller has it. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if P.device.type == "cpu":
        return cov_update_plain(P, K, H, HP)
    if P.device.type != "cuda":
        raise ValueError(f"cov update: unsupported device {P.device}")
    if HP is None:
        HP = H @ P
    K, HP = K.contiguous(), HP.contiguous()
    _check_cuda(P, K, HP)
    D, q = K.shape
    out = torch.empty_like(P)
    lib = _build.library("cov_update")
    entry = lib.cov_update_f32 if P.dtype == torch.float32 else lib.cov_update_f64
    rc = entry(P.data_ptr(), K.data_ptr(), HP.data_ptr(), out.data_ptr(), D, q,
               P.device.index, torch.cuda.current_stream(P.device).cuda_stream)
    if rc:
        raise RuntimeError(f"cov update: CUDA error {rc} at launch")
    cov_update.launches += 1
    return out


cov_update.launches = 0

for _fn in ("cov_update_f32", "cov_update_f64"):
    _build.declare("cov_update", _fn, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
