"""SO(3) operations, batched over leading dimensions.

Counterpart of ``orcvio_tpu/math/so3.py`` (reference: math_utils.hpp:27,
:230, :251). The small-angle branches are the same Taylor series, selected
with ``torch.where`` with a "safe theta" so that values and forward-mode
derivatives stay finite at theta = 0.
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


def vee(W):
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_theta(w):
    """(t2, theta, small), each (..., 1): theta = |w| where |w| >= _SMALL,
    else 1. The trailing axis keeps them off 0-d tensors, whose products
    with Python floats take float64 tangents under torch.func.jacfwd."""
    t2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = t2 < _SMALL2
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return t2, theta, small


def _coeff_a(t2, theta, small):
    """sin(t)/t."""
    return torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                       torch.sin(theta) / theta)


def _coeff_b(t2, theta, small):
    """(1 - cos(t)) / t^2."""
    return torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                       (1.0 - torch.cos(theta)) / (theta * theta))


def _coeff_c(t2, theta, small):
    """(t - sin(t)) / t^3."""
    return torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                       (theta - torch.sin(theta)) / (theta * (theta * theta)))


def _coeff_d(t2, theta, small):
    """(2(cos t - 1) + t^2) / (2 t^4), the Hl W^2 coefficient."""
    t2s = theta * theta
    return torch.where(small, 1.0 / 24.0 - t2 / 720.0 + t2 * t2 / 40320.0,
                       (2.0 * (torch.cos(theta) - 1.0) + t2s) / (2.0 * t2s * t2s))


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w):
    """Matrix exponential on SO(3) (Rodrigues), (..., 3) -> (..., 3, 3)."""
    t2, theta, small = _safe_theta(w)
    W = hat(w)
    a = _coeff_a(t2, theta, small)[..., None]
    b = _coeff_b(t2, theta, small)[..., None]
    return _eye_like(W) + a * W + b * (W @ W)


def log(R):
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3), |w| <= pi.

    Taylor on the skew part near theta = 0, axis from the dominant column
    of R + I near theta = pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_raw = (tr - 1.0) * 0.5
    eps = torch.finfo(R.dtype).eps
    theta = torch.arccos(torch.clamp(cos_raw, -1.0 + 4 * eps, 1.0 - 4 * eps))
    sin_t = torch.sin(theta)
    v = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    small = cos_raw > 1.0 - max(1e-9, 1e4 * eps)
    near_pi = theta > (torch.pi - 1e-3)
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_t), sin_t)
    w_generic = (theta / (2.0 * safe_sin))[..., None] * v
    s2 = 0.25 * torch.sum(v * v, dim=-1)
    w_small = (0.5 * (1.0 + s2 / 6.0))[..., None] * v
    A = R + _eye_like(R)
    k = torch.argmax(torch.linalg.norm(A, dim=-2), dim=-1)
    axis = torch.take_along_dim(A, k[..., None, None], dim=-1)[..., 0]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-12)
    sign = torch.where(torch.sum(axis * v, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    out = torch.where(small[..., None], w_small, w_generic)
    return torch.where(near_pi[..., None], w_pi, out)


def left_jacobian(w):
    """SO(3) left Jacobian Jl(w) = I + b W + c W^2. Ref: math_utils.hpp:251."""
    t2, theta, small = _safe_theta(w)
    W = hat(w)
    b = _coeff_b(t2, theta, small)[..., None]
    c = _coeff_c(t2, theta, small)[..., None]
    return _eye_like(W) + b * W + c * (W @ W)


def Hl(w):
    """Hl(w) = 0.5 I + c W + d W^2, the closed-form position operator.
    Ref: math_utils.hpp:230."""
    t2, theta, small = _safe_theta(w)
    W = hat(w)
    c = _coeff_c(t2, theta, small)[..., None]
    d = _coeff_d(t2, theta, small)[..., None]
    return 0.5 * _eye_like(W) + c * W + d * (W @ W)


def left_jacobian_inv(w):
    """Inverse of the SO(3) left Jacobian (closed form):
    I - W/2 + (1/t^2 - (1 + cos t) / (2 t sin t)) W^2."""
    t2, theta, small = _safe_theta(w)
    W = hat(w)
    cot_term = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / (theta * theta)
        - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)))
    return _eye_like(W) - 0.5 * W + cot_term[..., None] * (W @ W)
