"""Lie-group algebra for SO(3)/SE(3) (port of neural_invertible_warp_tpu/ops/lie.py).

The exp maps evaluate the truncated Taylor series in theta^2, which stays
smooth (and differentiable) at theta = 0.
"""

from __future__ import annotations

import torch


def skew_symmetric(w):
    """[...,3] -> [...,3,3] cross-product matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([zeros, -w2, w1], dim=-1),
        torch.stack([w2, zeros, -w0], dim=-1),
        torch.stack([-w1, w0, zeros], dim=-1),
    ], dim=-2)


def _taylor_sq(x2, kind, nth=10):
    """Series in theta^2: A = sin(x)/x, B = (1-cos x)/x^2, C = (x-sin x)/x^3."""
    ans = torch.zeros_like(x2)
    denom = 1.0
    for i in range(nth + 1):
        if kind == "A":
            if i > 0:
                denom *= (2 * i) * (2 * i + 1)
        elif kind == "B":
            denom *= (2 * i + 1) * (2 * i + 2)
        else:
            denom *= (2 * i + 2) * (2 * i + 3)
        ans = ans + ((-1) ** i) * x2 ** i / denom
    return ans


def so3_to_SO3(w):
    """Exponential map so(3) -> SO(3). [...,3] -> [...,3,3]."""
    wx = skew_symmetric(w)
    theta2 = torch.sum(w ** 2, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + _taylor_sq(theta2, "A") * wx + _taylor_sq(theta2, "B") * (wx @ wx)


def se3_to_SE3(wu):
    """Exponential map se(3) -> SE(3). [...,6] -> [...,3,4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta2 = torch.sum(w ** 2, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A = _taylor_sq(theta2, "A")
    B = _taylor_sq(theta2, "B")
    C = _taylor_sq(theta2, "C")
    R = eye + A * wx + B * (wx @ wx)
    V = eye + B * wx + C * (wx @ wx)
    t = V @ u[..., None]
    return torch.cat([R, t], dim=-1)
