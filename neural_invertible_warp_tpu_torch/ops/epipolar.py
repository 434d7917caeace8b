"""Batched cross-view projection geometry (port of
neural_invertible_warp_tpu/ops/epipolar.py, ``torch`` in place of ``jnp``).

Port of the pieces of reference utils/geometry/batched_geometry_utils.py used
by the COLMAP-initialization subsystem (sfm.py:34): lift pixels of image i to
3D with their depths and project them into image j, optionally depth-checking
against image j's depth map.
"""

from __future__ import annotations

import torch


def to_homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_homogeneous(x, eps=1e-8):
    return x[..., :-1] / (x[..., -1:] + eps)


def batch_project_to_other_img(kpi, di, Ki, Kj, T_itoj, return_depth=False):
    """Project pixels of image i into image j.

    Args:
        kpi: [B,N,2] pixel coordinates in image i.
        di: [B,N] depths of those pixels.
        Ki, Kj: [B,3,3] intrinsics.
        T_itoj: [B,4,4] rigid transform from camera i to camera j.
    Returns:
        kpi_j: [B,N,2] projections in image j (+ their depths in j if asked).
    """
    kpi_3d_i = to_homogeneous(kpi) @ torch.linalg.inv(Ki).transpose(-1, -2)
    kpi_3d_i = kpi_3d_i * di[..., None]
    kpi_3d_j = from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))
    kpi_j = from_homogeneous(kpi_3d_j @ Kj.transpose(-1, -2))
    if return_depth:
        return kpi_j, kpi_3d_j[..., -1]
    return kpi_j


def sample_depth_map(kp, depth_map):
    """Nearest-neighbor depth lookup at pixel coords. kp [B,N,2];
    depth_map [B,H,W] -> (depth [B,N], valid [B,N])."""
    B, H, W = depth_map.shape
    x = torch.round(kp[..., 0]).long()
    y = torch.round(kp[..., 1]).long()
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    x = torch.clamp(x, 0, W - 1)
    y = torch.clamp(y, 0, H - 1)
    d = torch.gather(depth_map.reshape(B, -1), 1, y * W + x)
    return d, inside & (d > 0)


def batch_project_to_other_img_and_check_depth(kpi, di, depthj, Ki, Kj,
                                               T_itoj, validi, rth=0.1,
                                               return_repro_error=False):
    """Project i->j and keep pixels whose projected depth agrees with j's
    depth map within a relative threshold (batched_geometry_utils.py:157-196)."""
    kpi_j, di_j = batch_project_to_other_img(kpi, di, Ki, Kj, T_itoj,
                                             return_depth=True)
    dj, validj = sample_depth_map(kpi_j, depthj)
    repro_error = torch.abs(di_j - dj) / torch.clamp(dj, min=1e-8)
    visible = validi & (repro_error < rth) & validj
    if return_repro_error:
        return kpi_j, visible, repro_error
    return kpi_j, visible
