"""Rigid/similarity alignment (port of neural_invertible_warp_tpu/ops/align.py).

* ``rigid_points_registration(method="quat")``: differentiable batched
  Kabsch fit. The rotation comes from the SVD-free Horn-quaternion solver
  (``ProcrustesQuat``, a ``torch.autograd.Function`` carrying the JAX
  package's implicit-differential VJP). The SVD method is ROADMAP M4's.
* ``procrustes_analysis_np`` / ``apply_sim3_to_poses``: the validation-time
  sim(3) between predicted and ground-truth camera centers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pose as pose_ops

_QUAT_SQUARINGS = 12   # B^(2^12): gap amplification for near-degenerate N
_QUAT_POLISH_ITERS = 4


def _horn_quat_matrix(M):
    """Horn's 4x4 symmetric N(M) with q^T N q = <R(q), M> for unit q."""
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    r0 = torch.stack([m[0][0] + m[1][1] + m[2][2], m[2][1] - m[1][2],
                      m[0][2] - m[2][0], m[1][0] - m[0][1]], -1)
    r1 = torch.stack([m[2][1] - m[1][2], m[0][0] - m[1][1] - m[2][2],
                      m[0][1] + m[1][0], m[0][2] + m[2][0]], -1)
    r2 = torch.stack([m[0][2] - m[2][0], m[0][1] + m[1][0],
                      m[1][1] - m[0][0] - m[2][2], m[1][2] + m[2][1]], -1)
    r3 = torch.stack([m[1][0] - m[0][1], m[0][2] + m[2][0],
                      m[1][2] + m[2][1], m[2][2] - m[0][0] - m[1][1]], -1)
    return torch.stack([r0, r1, r2, r3], -2)


def _quat_to_rot(q):
    """Unit quaternion (w,x,y,z) -> rotation matrix [...,3,3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


def _skew(u):
    z = torch.zeros_like(u[..., 0])
    return torch.stack([
        torch.stack([z, -u[..., 2], u[..., 1]], -1),
        torch.stack([u[..., 2], z, -u[..., 0]], -1),
        torch.stack([-u[..., 1], u[..., 0], z], -1)], -2)


def _vee(K):
    return torch.stack([K[..., 2, 1], K[..., 0, 2], K[..., 1, 0]], -1)


def _frob(P):
    return torch.sqrt(torch.sum(P * P, dim=(-2, -1), keepdim=True))


def procrustes_rotation_quat_fwd(M):
    """R = argmax_{R in SO(3)} <R, M>: the dominant eigenvector of
    B = N(M) + 2|M|_F I by 12 normalized squarings, then 4 power steps."""
    N = _horn_quat_matrix(M)
    eye4 = torch.eye(4, dtype=M.dtype, device=M.device)
    B = N + (2.0 * _frob(M) + 1e-30) * eye4
    P = B / _frob(B)
    for _ in range(_QUAT_SQUARINGS):
        P = P @ P
        P = P / _frob(P)
    idx = torch.argmax(torch.sum(P * P, dim=-2), dim=-1)          # [...]
    v = torch.take_along_dim(P, idx[..., None, None], dim=-1)[..., 0]
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    for _ in range(_QUAT_POLISH_ITERS):
        v = (B @ v[..., None])[..., 0]
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return _quat_to_rot(v)


def procrustes_rotation_quat_vjp(R, M, G):
    """Mbar = R [ (tr(S) I - S)^{-1} vee(R^T G - G^T R) ]x, S = sym(R^T M),
    with the 3x3 solve by adjugate and a clamped determinant."""
    S = R.transpose(-1, -2) @ M
    S = 0.5 * (S + S.transpose(-1, -2))
    trS = S[..., 0, 0] + S[..., 1, 1] + S[..., 2, 2]
    T = trS[..., None, None] * torch.eye(3, dtype=S.dtype, device=S.device) - S
    a = _vee(R.transpose(-1, -2) @ G - G.transpose(-1, -2) @ R)
    t00, t01, t02 = T[..., 0, 0], T[..., 0, 1], T[..., 0, 2]
    t11, t12, t22 = T[..., 1, 1], T[..., 1, 2], T[..., 2, 2]
    c00 = t11 * t22 - t12 * t12
    c01 = t02 * t12 - t01 * t22
    c02 = t01 * t12 - t02 * t11
    c11 = t00 * t22 - t02 * t02
    c12 = t01 * t02 - t00 * t12
    c22 = t00 * t11 - t01 * t01
    det = t00 * c00 + t01 * c01 + t02 * c02
    eps = torch.full_like(det, 1e-12)
    det = torch.where(torch.abs(det) < 1e-12,
                      torch.where(det < 0, -eps, eps), det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c01, c11, c12], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    u = (adj @ a[..., None])[..., 0] / det[..., None]
    return R @ _skew(u)


class ProcrustesQuat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, M):
        R = procrustes_rotation_quat_fwd(M)
        ctx.save_for_backward(R, M)
        return R

    @staticmethod
    def backward(ctx, G):
        R, M = ctx.saved_tensors
        return procrustes_rotation_quat_vjp(R, M, G)


def rigid_points_registration(x, y, method="quat"):
    """(R, t) with R @ x_i + t ~= y_i. x, y: [...,N,3]. Differentiable."""
    if method != "quat":
        raise NotImplementedError(
            "procrustes method {!r} is not ported yet (ROADMAP M4)".format(method))
    cx = torch.mean(x, dim=-2, keepdim=True)
    cy = torch.mean(y, dim=-2, keepdim=True)
    M = (y - cy).transpose(-1, -2) @ (x - cx)                      # [...,3,3]
    R = ProcrustesQuat.apply(M)
    t = cy[..., 0, :] - (R @ cx[..., 0, :, None])[..., 0]
    return R, t


def procrustes_analysis_np(X0, X1):
    """sim(3) aligning X1 to X0 (host, float64). Returns dict(t0, t1, s0, s1, R)
    with X1to0 = (X1 - t1)/s1 @ R.T * s0 + t0."""
    X0 = np.asarray(X0, dtype=np.float64)
    X1 = np.asarray(X1, dtype=np.float64)
    t0 = X0.mean(axis=0)
    t1 = X1.mean(axis=0)
    X0c = X0 - t0
    X1c = X1 - t1
    s0 = np.sqrt((X0c ** 2).sum(axis=-1).mean())
    s1 = np.sqrt((X1c ** 2).sum(axis=-1).mean())
    U, _, Vt = np.linalg.svd(X0c.T / s0 @ (X1c / s1))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return dict(t0=t0.astype(np.float32), t1=t1.astype(np.float32),
                s0=np.float32(s0), s1=np.float32(s1), R=R.astype(np.float32))


def apply_sim3_to_poses(pose, sim3, direction="pred_to_GT"):
    """Align a pose set with a sim3 from ``procrustes_analysis_np``:
    "pred_to_GT" moves optimized poses into the GT frame (pose error);
    "GT_to_pred" moves GT poses into the optimized frame (rendering)."""
    center = torch.zeros((pose.shape[0], 1, 3), dtype=pose.dtype,
                         device=pose.device)
    center = pose_ops.cam2world(center, pose)[:, 0]
    R, t0, t1, s0, s1 = (sim3[k] for k in ("R", "t0", "t1", "s0", "s1"))
    if direction == "pred_to_GT":
        center_aligned = (center - t1) / s1 @ R.T * s0 + t0
        R_aligned = pose[..., :3] @ R.T
    else:
        center_aligned = (center - t0) / s0 @ R * s1 + t1
        R_aligned = pose[..., :3] @ R
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return pose_ops.make_pose(R=R_aligned, t=t_aligned)
