"""SO(3) operations, batched over leading dimensions.

Counterpart of ``orcvio_tpu/math/so3.py`` (reference: math_utils.hpp:27).
Only what the front end uses is ported so far: ``hat`` and ``exp``. The
small-angle branch is the same Taylor series, selected with ``torch.where``.
"""
from __future__ import annotations

import torch

_SMALL = 1e-5
_SMALL2 = _SMALL * _SMALL


def hat(w):
    """Skew-symmetric matrix from (..., 3) vector. Ref: math_utils.hpp:27."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def exp(w):
    """Matrix exponential on SO(3) (Rodrigues), (..., 3) -> (..., 3, 3)."""
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < _SMALL2
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(theta)) / (theta * theta))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
