"""Host-side numpy geometry helpers (port of neural_invertible_warp_tpu/
utils/geometry_np.py, a copy; reference
utils/geometry/geometric_utils_numpy.py:21-180), used by the SfM
initialization path and evaluation tooling: pixel-grid generation,
intrinsics rescaling, back-projection / projection between views, and
relative-pose error metrics."""

from __future__ import annotations

import numpy as np


def get_absolute_coordinates(h_scale, w_scale):
    """[H,W,2] pixel coordinate grid (x, y)."""
    xx, yy = np.meshgrid(np.arange(w_scale), np.arange(h_scale))
    return np.dstack([xx, yy]).astype(np.float32)


def angles2rotation_matrix(angles):
    """Euler XYZ angles (rad) -> [3,3] rotation R = Rz @ Ry @ Rx."""
    ax, ay, az = angles
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)],
                   [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return Rz @ Ry @ Rx


def scale_intrinsics(K, scales, invert_scales=True):
    """Rescale intrinsics for a resized image. scales: (sx, sy)."""
    sx, sy = scales[0], scales[1]
    if invert_scales:
        sx, sy = 1.0 / sx, 1.0 / sy
    S = np.array([[sx, 0, 0], [0, sy, 0], [0, 0, 1.0]])
    return S @ np.asarray(K, np.float64)


def to_homogeneous(points):
    return np.concatenate(
        [points, np.ones_like(points[..., :1])], axis=-1)


def from_homogeneous(points, eps=1e-8):
    return points[..., :-1] / (points[..., -1:] + eps)


def backproject_to_3d(kpi, di, Ki, T_itoj=None):
    """Pixels kpi [N,2] with depths di [N] -> 3D (optionally mapped i->j)."""
    Kinv = np.linalg.inv(np.asarray(Ki, np.float64))
    pts = to_homogeneous(np.asarray(kpi, np.float64)) @ Kinv.T
    pts = pts * np.asarray(di, np.float64)[:, None]
    if T_itoj is not None:
        pts = from_homogeneous(to_homogeneous(pts) @ np.asarray(T_itoj).T)
    return pts


def project(kpi_3d, T_itoj, Kj):
    """3D points in frame i -> pixels in image j. T_itoj [4,4], Kj [3,3]."""
    pts_j = from_homogeneous(
        to_homogeneous(np.asarray(kpi_3d, np.float64))
        @ np.asarray(T_itoj, np.float64).T)
    return from_homogeneous(pts_j @ np.asarray(Kj, np.float64).T)


def angle_error_mat(R1, R2):
    """Angle (deg) between two rotation matrices."""
    cos = (np.trace(np.asarray(R1).T @ np.asarray(R2)) - 1) / 2
    return float(np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0)))))


def angle_error_vec(v1, v2):
    """Angle (deg) between two vectors."""
    n = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(np.rad2deg(np.arccos(np.clip(np.dot(v1, v2) / max(n, 1e-12),
                                              -1.0, 1.0))))


def compute_pose_error(T_0to1, R, t):
    """(rot err deg, trans-direction err deg) of an estimated relative pose
    against GT T_0to1 [4,4]. Translation error is direction-only (SfM scale
    ambiguity) and sign-symmetric."""
    T = np.asarray(T_0to1, np.float64)
    error_R = angle_error_mat(R, T[:3, :3])
    err_t = angle_error_vec(t, T[:3, 3])
    return error_R, float(min(err_t, 180.0 - err_t))
