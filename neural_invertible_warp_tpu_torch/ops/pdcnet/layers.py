"""Primitive layers of PDC-Net, inference only (port of
neural_invertible_warp_tpu/ops/pdcnet/layers.py).

NCHW activations and OIHW conv kernels as in the reference, eval-mode
BatchNorm, torch ``F.interpolate`` bilinear (half-pixel, no antialiasing) and
``area`` resizes, ``grid_sample(align_corners=True, padding_mode='zeros')``.
Modules carry the reference's ``state_dict`` names: the reference's ``conv()``
helper is a Sequential of Conv2d (``.0``), BatchNorm2d (``.1``) and
LeakyReLU(0.1), so a checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


# ------------------------------------------------------------------ init

def kaiming_(w, generator):
    """torch kaiming_normal_(mode='fan_in') through an explicit generator."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    return w


def conv2d(c_in, c_out, k, generator, bias=True):
    """A Conv2d with a kaiming kernel and a zero bias."""
    m = nn.Conv2d(c_in, c_out, k, bias=bias)
    kaiming_(m.weight, generator)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def bilinear_deconv_kernel(c, k=4):
    """BilinearConvTranspose2d init (reference models/modules/mod.py):
    per-channel bilinear upsampling kernel [c,c,k,k], zero across channels."""
    f = (k + 1) // 2
    center = f - 1 if k % 2 == 1 else f - 0.5
    og = np.arange(k, dtype=np.float64)
    filt1d = 1 - np.abs(og - center) / f
    w = np.zeros((c, c, k, k), np.float32)
    for i in range(c):
        w[i, i] = np.outer(filt1d, filt1d)
    return torch.from_numpy(w)


def deconv(c_in, c_out, generator=None):
    """ConvTranspose2d(k 4, stride 2, padding 1), torch (in, out, kH, kW)
    layout: a bilinear kernel without a generator (deconv4, deconv2), else
    kaiming (upfeat2); zero bias."""
    m = nn.ConvTranspose2d(c_in, c_out, 4, stride=2, padding=1)
    with torch.no_grad():
        if generator is None:
            m.weight.copy_(bilinear_deconv_kernel(c_in))
        else:
            kaiming_(m.weight, generator)
        m.bias.zero_()
    return m


class ConvBlock(nn.Sequential):
    """The reference's ``conv()``: Conv2d [+ BatchNorm2d] [+ LeakyReLU(0.1)],
    with symmetric padding and dilation given at the call. BatchNorm always
    runs with its running statistics (inference only)."""

    def __init__(self, c_in, c_out, k, generator, bias=True, bn=True):
        layers = [conv2d(c_in, c_out, k, generator, bias=bias)]
        if bn:
            norm = nn.BatchNorm2d(c_out, eps=BN_EPS)
            with torch.no_grad():        # torch<=1.1 init the reference keeps
                norm.weight.uniform_(0.0, 1.0, generator=generator)
            layers.append(norm)
        super().__init__(*layers)

    def forward(self, x, padding=1, dilation=1, relu=True):
        conv = self[0]
        x = F.conv2d(x, conv.weight, conv.bias, padding=padding, dilation=dilation)
        if len(self) > 1:
            bn = self[1]
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
        return lrelu(x) if relu else x


def conv_plain(m, x, padding=1):
    return F.conv2d(x, m.weight, m.bias, padding=padding)


def lrelu(x, slope=0.1):
    return F.leaky_relu(x, slope)


def maxpool2(x):
    return F.max_pool2d(x, 2, 2)


# ------------------------------------------------------------------ resize

def interp_bilinear(x, out_hw):
    """torch F.interpolate(mode='bilinear', align_corners=False) on NCHW."""
    return F.interpolate(x, (int(out_hw[0]), int(out_hw[1])), mode="bilinear",
                         align_corners=False)


def interp_area(x, out_hw):
    """torch F.interpolate(mode='area') == adaptive average pooling."""
    return F.interpolate(x, (int(out_hw[0]), int(out_hw[1])), mode="area")


# ------------------------------------------------------------------ warping

def grid_sample_zeros(x, vgrid):
    """grid_sample(align_corners=True, padding_mode='zeros'); x [B,C,H,W],
    vgrid [B,2,H,W] normalised coordinates in [-1,1] (x then y)."""
    return F.grid_sample(x, vgrid.permute(0, 2, 3, 1), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _pixel_grid(B, H, W, like):
    xx = torch.arange(W, dtype=like.dtype, device=like.device)[None, :].expand(H, W)
    yy = torch.arange(H, dtype=like.dtype, device=like.device)[:, None].expand(H, W)
    return torch.stack([xx, yy])[None]                       # [1,2,H,W]


def warp(x, flow):
    """Backward-warp x [B,C,H,W] by flow [B,2,H,W] (reference
    base_matching_net.py:228-262)."""
    B, C, H, W = x.shape
    vgrid = _pixel_grid(B, H, W, x) + flow
    vx = 2.0 * vgrid[:, 0] / max(W - 1, 1) - 1.0
    vy = 2.0 * vgrid[:, 1] / max(H - 1, 1) - 1.0
    return grid_sample_zeros(x, torch.stack([vx, vy], dim=1))


# ------------------------------------------------------------------ misc

def l2norm_channel(x, eps=1e-6):
    """FeatureL2Norm over the channel dim (DGC-Net convention)."""
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


def unnormalise_and_convert_mapping_to_flow(mapping):
    """Normalised [-1,1] mapping [B,2,H,W] -> flow in pixels (mod.py:48-66)."""
    B, _, H, W = mapping.shape
    mx = (mapping[:, 0] + 1) * (W - 1) / 2.0
    my = (mapping[:, 1] + 1) * (H - 1) / 2.0
    grid = _pixel_grid(B, H, W, mapping)
    return torch.stack([mx - grid[:, 0], my - grid[:, 1]], dim=1)
