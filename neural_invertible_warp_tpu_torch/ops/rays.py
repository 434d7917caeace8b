"""Ray generation from ray indices (port of neural_invertible_warp_tpu/ops/rays.py).

Pixel centers sit at (x+0.5, y+0.5) with row-major index y*W + x; grid
points live on the z=1 camera plane; rays are grid - center, unnormalized;
``convert_NDC`` maps them to normalized device coordinates.
"""

from __future__ import annotations

import torch

from . import pose as pose_ops


def pixel_centers_from_idx(ray_idx, W):
    """[N] ray indices -> [N,2] (x+0.5, y+0.5)."""
    x = (ray_idx % W).to(torch.float32) + 0.5
    y = torch.div(ray_idx, W, rounding_mode="floor").to(torch.float32) + 0.5
    return torch.stack([x, y], dim=-1)


def _grid_cam(xy, intr):
    """Lift pixel centers onto the z=1 camera plane, in the intrinsics'
    dtype: [N,2],[B,3,3] -> [B,N,3]."""
    return pose_ops.img2cam(pose_ops.to_hom(xy.to(intr.dtype))[None], intr)


def get_center_and_ray(pose, intr, ray_idx, W):
    """World-space camera centers and rays for the pixels ``ray_idx``.

    pose: [B,3,4] w2c; intr: [B,3,3]. Returns center, ray: [B,N,3] each.
    """
    grid_3D = _grid_cam(pixel_centers_from_idx(ray_idx, W), intr)
    center_3D = torch.zeros_like(grid_3D)
    grid_3D = pose_ops.cam2world(grid_3D, pose)
    center_3D = pose_ops.cam2world(center_3D, pose)
    return center_3D, grid_3D - center_3D


def get_unwarped_center_and_ray(intr, ray_idx, W, pose_init=None):
    """Camera-frame (center, grid) points fed to the INN warp: the centers
    are the camera origin, the grid points lie on the z=1 plane, unless
    ``pose_init`` [B,3,4] maps both into an initial world frame."""
    grid_3D = _grid_cam(pixel_centers_from_idx(ray_idx, W), intr)
    center_3D = torch.zeros_like(grid_3D)
    if pose_init is not None:
        grid_3D = pose_ops.cam2world(grid_3D, pose_init)
        center_3D = pose_ops.cam2world(center_3D, pose_init)
    return center_3D, grid_3D


def convert_NDC(center, ray, intr, near=1.0):
    """Shift the ray origins to the near plane and project to NDC, with the
    cameras facing +z (the reference's convention, not the usual -z).
    center/ray [B,N,3], intr [B,3,3] -> (center, ray) [B,N,3]."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    center_ndc = torch.stack([scale_x * (cx / cz), scale_y * (cy / cz),
                              1 - 2 * near / cz], dim=-1)
    ray_ndc = torch.stack([scale_x * (rx / rz - cx / cz), scale_y * (ry / rz - cy / cz),
                           2 * near / cz], dim=-1)
    return center_ndc, ray_ndc
