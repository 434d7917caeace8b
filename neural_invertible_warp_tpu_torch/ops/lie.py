"""Lie-group algebra for SO(3)/SE(3), quaternions and 6D rotations (port of
neural_invertible_warp_tpu/ops/lie.py).

The exp maps evaluate the truncated Taylor series in theta^2, which stays
smooth (and differentiable) at theta = 0; the log maps clamp the rotation
angle away from 0 and pi, as the reference does. Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import math

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


def taylor_A(x, nth=10):
    """sin(x) / x."""
    return _taylor_sq(x ** 2, "A", nth)


def taylor_B(x, nth=10):
    """(1 - cos x) / x^2."""
    return _taylor_sq(x ** 2, "B", nth)


def taylor_C(x, nth=10):
    """(x - sin x) / x^3."""
    return _taylor_sq(x ** 2, "C", nth)


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


def SO3_to_so3(R, eps=1e-7):
    """Log map SO(3) -> so(3). [...,3,3] -> [...,3]; the angle is clamped
    into [acos(1 - eps), acos(-1 + eps)] and wrapped modulo pi, where ln(R)
    explodes."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))[..., None, None] \
        % math.pi
    lnR = 1 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def SE3_to_se3(Rt, eps=1e-8):
    """Log map SE(3) -> se(3). [...,3,4] -> [...,6]."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A = taylor_A(theta)
    B = taylor_B(theta)
    invV = eye - 0.5 * wx + (1 - A / (2 * B)) / (theta ** 2 + eps) * (wx @ wx)
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


def q_to_R(q):
    """Unit quaternion [...,4] -> rotation [...,3,3]."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], dim=-1),
    ], dim=-2)


def R_to_q(R, eps=1e-8):
    """Rotation [...,3,3] -> quaternion [...,4], branchless: each component's
    magnitude from the diagonal (floored at eps under the root), the signs of
    x, y, z from the skew part."""
    R00, R11, R22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = R00 + R11 + R22
    qa = 0.5 * torch.sqrt(torch.clamp(1 + t, min=eps))
    qb = torch.sign(R[..., 2, 1] - R[..., 1, 2]) * 0.5 \
        * torch.sqrt(torch.clamp(1 + R00 - R11 - R22, min=eps))
    qc = torch.sign(R[..., 0, 2] - R[..., 2, 0]) * 0.5 \
        * torch.sqrt(torch.clamp(1 - R00 + R11 - R22, min=eps))
    qd = torch.sign(R[..., 1, 0] - R[..., 0, 1]) * 0.5 \
        * torch.sqrt(torch.clamp(1 - R00 - R11 + R22, min=eps))
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q):
    norm2 = torch.sum(q ** 2, dim=-1, keepdim=True)
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device) / norm2


def q_product(q1, q2):
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


def sixd_to_SE3(w, eps=1e-8):
    """[...,9] (the 6D rotation of Zhou et al. + a translation) -> [...,3,4]:
    Gram-Schmidt on the two 3-vectors, the third axis their cross product."""
    r, t = w[..., :6], w[..., 6:]
    x_raw, y_raw = r[..., :3], r[..., 3:]
    x = x_raw / torch.clamp(torch.linalg.norm(x_raw, dim=-1, keepdim=True), min=eps)
    y_ortho = y_raw - torch.sum(x * y_raw, dim=-1, keepdim=True) * x
    y = y_ortho / torch.clamp(torch.linalg.norm(y_ortho, dim=-1, keepdim=True), min=eps)
    z = torch.linalg.cross(x, y, dim=-1)
    R = torch.stack([x, y, z], dim=-1)
    return torch.cat([R, t[..., None]], dim=-1)
