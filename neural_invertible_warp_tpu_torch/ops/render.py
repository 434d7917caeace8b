"""Alpha compositing (port of neural_invertible_warp_tpu/ops/render.py):

    dist_i  = (d_{i+1} - d_i) * ||ray||     (last interval = 1e10)
    alpha_i = 1 - exp(-sigma_i * dist_i)
    T_i     = exp(-sum_{j<i} sigma_j * dist_j)   (exclusive cumsum)
    w_i     = T_i * alpha_i
    rgb     = sum_i w_i rgb_i ; depth = sum_i w_i d_i ; opacity = sum_i w_i
"""

from __future__ import annotations

import torch


def composite(ray, rgb_samples, density_samples, depth_samples,
              setbg_opaque=False, bgcolor=None):
    """ray [B,R,3]; rgb_samples [B,R,K,3]; density [B,R,K]; depth [B,R,K,1].

    Returns (rgb [B,R,3], depth [B,R,1], opacity [B,R,1], prob [B,R,K,1]).
    """
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)          # [B,R,1]
    depth = depth_samples[..., 0]                                      # [B,R,K]
    intv = depth[..., 1:] - depth[..., :-1]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    dist = intv * ray_length
    sigma_delta = density_samples * dist
    alpha = 1 - torch.exp(-sigma_delta)
    shifted = torch.cat([torch.zeros_like(sigma_delta[..., :1]),
                         sigma_delta[..., :-1]], dim=-1)
    T = torch.exp(-torch.cumsum(shifted, dim=-1))
    prob = (T * alpha)[..., None]                                      # [B,R,K,1]
    out_depth = torch.sum(depth_samples * prob, dim=-2)
    out_rgb = torch.sum(rgb_samples * prob, dim=-2)
    opacity = torch.sum(prob, dim=-2)
    if setbg_opaque:
        out_rgb = out_rgb + bgcolor * (1 - opacity)
    return out_rgb, out_depth, opacity, prob
