"""Gaussian-window SSIM (port of neural_invertible_warp_tpu/ops/ssim.py):
11x11 Gaussian window (sigma 1.5), per-channel depthwise convolution with
same-padding, C1 = 0.01^2, C2 = 0.03^2, averaged over the image. On the card
the convolution goes through cuDNN: callers that need fp32 results pin
``torch.backends.cudnn.allow_tf32 = False`` (``evaluate_full`` does).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size=11, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def _filter(img, window):
    """Depthwise 2D conv with same padding. img: [B,C,H,W]."""
    C = img.shape[1]
    k = window.shape[0]
    kernel = window.to(img.device, img.dtype).expand(C, 1, k, k)
    return F.conv2d(img, kernel, padding=k // 2, groups=C)


def ssim(img1, img2, window_size=11):
    """Mean SSIM over [B,C,H,W] float images in [0,1]."""
    window = _gaussian_window(window_size)
    mu1 = _filter(img1, window)
    mu2 = _filter(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter(img1 * img1, window) - mu1_sq
    sigma2_sq = _filter(img2 * img2, window) - mu2_sq
    sigma12 = _filter(img1 * img2, window) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)
