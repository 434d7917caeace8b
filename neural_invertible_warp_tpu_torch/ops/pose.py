"""Rigid camera-pose operations on [...,3,4] = [R|t] world-to-camera matrices
(port of neural_invertible_warp_tpu/ops/pose.py). ``compose([p1, p2])``
applies p1 first, then p2.
"""

from __future__ import annotations

import torch


def make_pose(R=None, t=None):
    """Assemble [...,3,4] from rotation and/or translation."""
    assert R is not None or t is not None
    if R is None:
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(
            t.shape[:-1] + (3, 3))
    elif t is None:
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def identity_pose(batch_shape=(), dtype=torch.float32, device=None):
    eye = torch.eye(3, 4, dtype=dtype, device=device)
    return eye.expand(tuple(batch_shape) + (3, 4))


def invert_pose(pose):
    """[R|t] -> [R^T | -R^T t]."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-2, -1)
    t_inv = (-R_inv @ t)[..., 0]
    return make_pose(R=R_inv, t=t_inv)


def compose_pair(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return make_pose(R=R_b @ R_a, t=(R_b @ t_a + t_b)[..., 0])


def compose(pose_list):
    """Compose a sequence: poseN o ... o pose1."""
    out = pose_list[0]
    for p in pose_list[1:]:
        out = compose_pair(out, p)
    return out


def to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def cam2world(X, pose):
    """Apply the inverse of a w2c pose: [...,N,3], [...,3,4] -> [...,N,3]."""
    return to_hom(X) @ invert_pose(pose).transpose(-1, -2)


def img2cam(X, intr):
    return X @ torch.linalg.inv(intr).transpose(-2, -1)


def rotation_distance(R1, R2, eps=1e-7):
    """Angle (rad) between two rotations."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def pose_distance(pose_a, pose_b):
    """(rotation angle, translation L2) between two pose sets."""
    R_err = rotation_distance(pose_a[..., :3], pose_b[..., :3])
    t_err = torch.linalg.norm(pose_a[..., 3] - pose_b[..., 3], dim=-1)
    return R_err, t_err
