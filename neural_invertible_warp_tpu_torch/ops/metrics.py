"""Depth-error metrics and masked PSNR of the DTU evaluation (port of
neural_invertible_warp_tpu/ops/metrics.py): mask-weighted reductions, no
boolean gathers.
"""

from __future__ import annotations

import torch


def _masked_sums(pred, gt, mask):
    """[sum |e|, sum e^2, n] of the masked error. pred/gt/mask: same shape."""
    mask = mask.to(pred.dtype)
    diff = (pred - gt) * mask
    return torch.stack([torch.sum(torch.abs(diff)), torch.sum(diff ** 2), torch.sum(mask)])


def abs_rmse_from_sums(sums):
    """Masked |e| mean and RMSE from ``_masked_sums``' [3] (summed over
    ranks where the rays are sharded)."""
    n = sums[2]
    return sums[0] / (n + 1e-6), torch.sqrt(sums[1] / (n + 1e-6))


def _masked_abs_rmse(pred, gt, mask):
    """Masked |e| mean and RMSE. pred/gt/mask: same shape."""
    return abs_rmse_from_sums(_masked_sums(pred, gt, mask))


def depth_error_sums_on_rays(pred_depth, depth_gt_pixels, valid_pixels, ray_idx):
    """[sum |e|, sum e^2, n] of the depth error at sampled rays. pred_depth
    [B,N,1] rendered depth; depth_gt_pixels, valid_pixels [B,HW] row-major;
    ray_idx [N] shared."""
    gt = depth_gt_pixels[:, ray_idx][..., None]
    valid = valid_pixels[:, ray_idx][..., None]
    return _masked_sums(pred_depth, gt, valid)


def depth_error_on_rays(pred_depth, depth_gt_pixels, valid_pixels, ray_idx,
                        scaling_factor=1.0):
    """Depth error at sampled rays: (|e| mean, RMSE)."""
    return abs_rmse_from_sums(depth_error_sums_on_rays(
        pred_depth * scaling_factor, depth_gt_pixels, valid_pixels, ray_idx))


def depth_error_full(pred_depth, depth_gt, valid, scaling_factor=1.0):
    """Full-image depth error: the smaller of the scaled and unscaled errors."""
    pred = pred_depth.reshape(-1)
    gt = depth_gt.reshape(-1)
    mask = valid.reshape(-1)
    abs_u, rmse_u = _masked_abs_rmse(pred, gt, mask)
    abs_s, rmse_s = _masked_abs_rmse(pred * scaling_factor, gt, mask)
    return torch.minimum(abs_u, abs_s), torch.minimum(rmse_u, rmse_s)


def white_composite(img, mask):
    """Composite the foreground onto a white background: img*m + (1-m).
    img [H,W,3]; mask [H,W] (1 = foreground)."""
    m = mask[..., None].to(img.dtype)
    return img * m + (1.0 - m)


def masked_psnr(pred, gt, mask):
    """Masked PSNR: both images are white-composited with the foreground
    mask and the PSNR is taken over all pixels (background pixels agree
    exactly: no error, but they count in the normalization)."""
    mse = torch.mean((white_composite(pred, mask) - white_composite(gt, mask)) ** 2)
    return -10.0 * torch.log10(mse + 1e-12)
