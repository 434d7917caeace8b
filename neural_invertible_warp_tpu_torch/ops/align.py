"""Rigid/similarity alignment (port of neural_invertible_warp_tpu/ops/align.py).

* ``rigid_points_registration``: differentiable batched (weighted) Kabsch
  fit. The rotation comes from the SVD-free Horn-quaternion solver (method
  "quat": ``ProcrustesQuat``, a ``torch.autograd.Function`` carrying the JAX
  package's implicit-differential VJP) or from the SVD with a determinant
  flip (method "svd": ``ProcrustesSVD``, carrying the JAX package's
  orthogonal-Procrustes differential, whose denominators are sums of
  singular values; torch's own SVD backward divides by their differences).
* ``procrustes_analysis_np`` / ``procrustes_analysis`` (host float64 / tensor
  fp32) and ``apply_sim3_to_poses``: the validation-time sim(3) between
  predicted and ground-truth camera centers.
* The DTU trajectory alignment (host numpy, float64, copied from the JAX
  package): ``align_umeyama`` (the ATE toolbox's sim(3)),
  ``prealign_w2c_large_camera_systems`` (ATE, more than 9 cameras),
  ``prealign_w2c_small_camera_systems`` (exhaustive pairwise search, 9 or
  fewer), ``apply_traj_align_ssim``, ``backtrack_from_aligning_the_trajectory``
  (GT poses into the optimized frame), ``align_translations`` and
  ``_pose_errors_np``.
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


def procrustes_rotation_svd_fwd(M):
    """R = argmax_{R in SO(3)} <R, M> by SVD with a determinant flip of the
    last singular direction. Returns (R, U, s, Vt, c), c [...,3] the signs."""
    U, s, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    c = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * c[..., None, :]) @ Vt
    return R, U, s, Vt, c


def procrustes_rotation_svd_vjp(U, s, Vt, c, G):
    """Mbar = U Q V^T with, for G' = U^T G V, Q_ij = c_j (G'_ij - G'_ji) /
    (s_i + s_j) where c_i c_j > 0, (c_j G'_ij - c_i G'_ji) / (s_j - s_i)
    (clamped away from 0) elsewhere, and a zero diagonal."""
    eps = 1e-8
    Gp = U.transpose(-1, -2) @ G @ Vt.transpose(-1, -2)
    ci, cj = c[..., :, None], c[..., None, :]
    si, sj = s[..., :, None], s[..., None, :]
    GpT = Gp.transpose(-1, -2)
    Q_same = cj * (Gp - GpT) / (si + sj + eps)
    diff = sj - si
    eps_t = torch.full_like(diff, eps)
    denom_mix = torch.where(torch.abs(diff) < eps,
                            torch.where(diff < 0, -eps_t, eps_t), diff)
    Q_mix = (cj * Gp - ci * GpT) / denom_mix
    Q = torch.where(ci * cj > 0, Q_same, Q_mix)
    Q = Q * (1.0 - torch.eye(3, dtype=Q.dtype, device=Q.device))
    return U @ Q @ Vt


class ProcrustesSVD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, M):
        R, U, s, Vt, c = procrustes_rotation_svd_fwd(M)
        ctx.save_for_backward(U, s, Vt, c)
        return R

    @staticmethod
    def backward(ctx, G):
        return procrustes_rotation_svd_vjp(*ctx.saved_tensors, G)


def rigid_points_registration(x, y, weights=None, method="svd"):
    """(R, t) with R @ x_i + t ~= y_i in the (weighted) least-squares sense.
    x, y: [...,N,3]; weights: optional [...,N] nonnegative; method "svd" or
    "quat" (the same rotation). Differentiable."""
    rot_fn = {"svd": ProcrustesSVD, "quat": ProcrustesQuat}[method]
    if weights is not None:
        w = weights[..., None]
        wsum = torch.sum(w, dim=-2, keepdim=True)
        cx = torch.sum(x * w, dim=-2, keepdim=True) / wsum
        cy = torch.sum(y * w, dim=-2, keepdim=True) / wsum
        M = ((y - cy) * w).transpose(-1, -2) @ (x - cx)            # [...,3,3]
    else:
        cx = torch.mean(x, dim=-2, keepdim=True)
        cy = torch.mean(y, dim=-2, keepdim=True)
        M = (y - cy).transpose(-1, -2) @ (x - cx)
    R = rot_fn.apply(M)
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


def procrustes_analysis(X0, X1):
    """Tensor version of ``procrustes_analysis_np`` (fp32, on X0's device)."""
    t0 = X0.mean(dim=0)
    t1 = X1.mean(dim=0)
    X0c = X0 - t0
    X1c = X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    U, _, Vt = torch.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = U @ Vt
    if torch.linalg.det(R) < 0:
        R = torch.cat([R[:2], -R[2:]], dim=0)
    return dict(t0=t0, t1=t1, s0=s0, s1=s1, R=R)


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


# ---------------------------------------------------------------------------
# Trajectory alignment for the DTU path (host-side numpy, float64)
# Parity: reference align_trajectories.py + model/barf_dtu.py:196-322
# ---------------------------------------------------------------------------

def align_umeyama(model, data, known_scale=False, yaw_only=False):
    """Umeyama sim(3): s, R, t with model ~= s * R @ data + t (host, float64).

    Port of the vendored ATE toolbox (third_party/ATE/align_trajectory.py:28-84)
    used by the DTU alignment path.
    """
    model = np.asarray(model, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    mu_M = model.mean(axis=0)
    mu_D = data.mean(axis=0)
    model_zc = model - mu_M
    data_zc = data - mu_D
    n = model.shape[0]
    C = (model_zc.T @ data_zc) / n
    sigma2 = (data_zc ** 2).sum() / n
    U, D_diag, Vt = np.linalg.svd(C)
    D = np.diag(D_diag)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    if yaw_only:
        rot_C = data_zc.T @ model_zc
        theta = _get_best_yaw(rot_C)
        R = _rot_z(theta)
    else:
        R = U @ S @ Vt
    # a collapsed point cloud (all centers equal, e.g. identity-init poses)
    # has sigma2 ~ 0: the reference forces s=1 there instead of dividing to
    # inf/NaN (third_party/ATE/align_trajectory.py:59-66, 80); the +1e-6 in
    # the divisor is also the reference's
    if known_scale or sigma2 < 1e-5:
        s = 1.0
    else:
        s = float(np.trace(D @ S) / (sigma2 + 1e-6))
    t = mu_M - s * R @ mu_D
    return s, R, t


def _get_best_yaw(C):
    A = C[0, 1] - C[1, 0]
    B = C[0, 0] + C[1, 1]
    return np.pi / 2 - np.arctan2(B, A)


def _rot_z(theta):
    R = np.eye(3)
    R[0, 0] = np.cos(theta)
    R[0, 1] = -np.sin(theta)
    R[1, 0] = np.sin(theta)
    R[1, 1] = np.cos(theta)
    return R


def _np_invert_pose(pose):
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = np.swapaxes(R, -1, -2)
    t_inv = (-R_inv @ t)[..., 0]
    return np.concatenate([R_inv, t_inv[..., None]], axis=-1)


def align_ate_c2b_use_a2b(traj_a_c2w, traj_b_c2w):
    """Umeyama sim(3) from trajectory a to b, applied to a. Returns
    (traj_a_aligned_c2w [N,3,4], ssim) with ssim = dict(R [3,3], t [3,1], s,
    type='traj_align') such that b ~= s * R @ a + t on camera positions
    (reference align_trajectories.py:89-138)."""
    traj_a = np.asarray(traj_a_c2w, np.float64)
    traj_b = np.asarray(traj_b_c2w, np.float64)
    s, R, t = align_umeyama(traj_b[:, :3, 3], traj_a[:, :3, 3])
    R_a = traj_a[:, :3, :3]
    t_a = traj_a[:, :3, 3:4]
    R_aligned = R[None] @ R_a
    t_aligned = s * (R[None] @ t_a) + t.reshape(1, 3, 1)
    aligned = np.concatenate([R_aligned, t_aligned], axis=2).astype(np.float32)
    ssim = dict(R=R.astype(np.float32), t=t.reshape(3, 1).astype(np.float32),
                s=float(s), type="traj_align")
    return aligned, ssim


def apply_traj_align_ssim(pose_w2c, ssim):
    """Apply a fitted 'traj_align' sim(3) to any w2c pose set, so that it can
    be fit on a trusted subset and applied to the whole set."""
    pose_c2w = _np_invert_pose(np.asarray(pose_w2c, np.float32))
    R, t, s = ssim["R"], np.reshape(ssim["t"], (1, 3, 1)), ssim["s"]
    R_aligned = R[None] @ pose_c2w[:, :3, :3]
    t_aligned = s * (R[None] @ pose_c2w[:, :3, 3:4]) + t
    aligned = np.concatenate([R_aligned, t_aligned], axis=2).astype(np.float32)
    return _np_invert_pose(aligned)


def backtrack_from_aligning_the_trajectory(pose_GT_w2c, ssim):
    """Move GT test poses into the optimized coordinate frame
    (reference align_trajectories.py:56-62)."""
    pose_GT_w2c = np.asarray(pose_GT_w2c, np.float32)
    pose_GT_c2w = _np_invert_pose(pose_GT_w2c)
    R, t, s = ssim["R"], ssim["t"].reshape(3, 1), ssim["s"]
    R_aligned = R.T[None] @ pose_GT_c2w[:, :3, :3]
    t_aligned = (R.T / s)[None] @ (pose_GT_c2w[:, :3, 3:4] - t[None])
    pose_c2w_aligned = np.concatenate([R_aligned, t_aligned], axis=2)
    return _np_invert_pose(pose_c2w_aligned.astype(np.float32))


def align_translations(GT_poses_w2c, initial_poses_w2c):
    """Shift the initial c2w camera centers onto the GT centers' mean
    (reference align_trajectories.py:65-86). Both [N,3,4] w2c."""
    GT_c2w = _np_invert_pose(np.asarray(GT_poses_w2c, np.float32))
    init_c2w = _np_invert_pose(np.asarray(initial_poses_w2c, np.float32))
    trans_error = GT_c2w[:, :3, 3].mean(0) - init_c2w[:, :3, 3].mean(0)
    init_c2w[:, :3, 3] += trans_error
    return _np_invert_pose(init_c2w)


def _pose_errors_np(pose_aligned_w2c, pose_GT_w2c):
    """Rotation (rad) and camera-center translation errors, c2w convention
    (reference model/barf_dtu.py:164-194)."""
    a_c2w = _np_invert_pose(np.asarray(pose_aligned_w2c, np.float64))
    g_c2w = _np_invert_pose(np.asarray(pose_GT_w2c, np.float64))
    R_diff = a_c2w[:, :, :3] @ np.swapaxes(g_c2w[:, :, :3], -1, -2)
    trace = np.clip((np.trace(R_diff, axis1=-2, axis2=-1) - 1) / 2,
                    -1 + 1e-7, 1 - 1e-7)
    R_err = np.arccos(trace)
    t_err = np.linalg.norm(a_c2w[:, :, 3] - g_c2w[:, :, 3], axis=-1)
    return R_err, t_err


def prealign_w2c_large_camera_systems(pose_w2c, pose_GT_w2c):
    """ATE/Umeyama sim(3) alignment (more than 9 cameras;
    model/barf_dtu.py:196-226). Returns (aligned w2c, ssim)."""
    pose_c2w = _np_invert_pose(np.asarray(pose_w2c, np.float32))
    pose_GT_c2w = _np_invert_pose(np.asarray(pose_GT_w2c, np.float32))
    try:
        aligned_c2w, ssim = align_ate_c2b_use_a2b(pose_c2w, pose_GT_c2w)
        pose_aligned_w2c = _np_invert_pose(aligned_c2w)
    except np.linalg.LinAlgError:
        pose_aligned_w2c = np.asarray(pose_w2c, np.float32)
        ssim = dict(R=np.eye(3, dtype=np.float32),
                    t=np.zeros((3, 1), np.float32), s=1.0, type="traj_align")
    return pose_aligned_w2c, ssim


def prealign_w2c_small_camera_systems(pose_w2c, pose_GT_w2c):
    """Exhaustive pairwise alignment for 9 or fewer cameras
    (reference model/barf_dtu.py:229-322): for every camera pair, rescale by
    the pair distance ratio and align the first pose exactly; keep the
    candidate with the smallest rotation*translation error product."""
    pose_w2c = np.asarray(pose_w2c, np.float32)
    pose_GT_w2c = np.asarray(pose_GT_w2c, np.float32)
    pose_c2w = _np_invert_pose(pose_w2c)
    pose_GT_c2w = _np_invert_pose(pose_GT_w2c)
    B = pose_c2w.shape[0]

    def pad(p):
        out = np.tile(np.eye(4, dtype=np.float64), (p.shape[0], 1, 1))
        out[:, :3] = p
        return out

    from_p = pad(pose_c2w)
    to_p = pad(pose_GT_c2w)

    best = None
    for a in range(min(B, 10)):
        for b in range(min(B, 10)):
            if a == b:
                continue
            f = from_p.copy()
            dist_from = np.linalg.norm(f[a, :3, 3] - f[b, :3, 3])
            dist_to = np.linalg.norm(to_p[a, :3, 3] - to_p[b, :3, 3])
            scale = dist_to / max(dist_from, 1e-12)
            f[:, :3, 3] *= scale
            T = to_p[a] @ np.linalg.inv(f[a])
            aligned_c2w = (T[None] @ f)[:, :3].astype(np.float32)
            aligned_w2c = _np_invert_pose(aligned_c2w)
            R_err, t_err = _pose_errors_np(aligned_w2c, pose_GT_w2c)
            score = float(t_err.mean()) * float(np.rad2deg(R_err.mean()))
            ssim = dict(R=T[:3, :3].astype(np.float32),
                        t=T[:3, 3].reshape(3, 1).astype(np.float32),
                        s=float(scale), type="traj_align")
            if best is None or score < best[0]:
                best = (score, aligned_w2c, ssim)
    return best[1], best[2]
