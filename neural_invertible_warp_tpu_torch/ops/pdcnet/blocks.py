"""PDC-Net's decoder, refinement and uncertainty blocks (port of
neural_invertible_warp_tpu/ops/pdcnet/blocks.py; reference
third_party/DenseMatching/models/modules/mod.py and
models/PDCNet/mod_uncertainty.py), as modules with the reference's
``state_dict`` names."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from . import layers as L


# --------------------------------------------------- residual decoders

class ResidualDecoder(nn.Module):
    """Shared trunk of CMDTopResidualConnections (head ``final``) and
    OpticalFlowEstimatorResidualConnection (head ``predict_flow``)."""

    def __init__(self, in_channels, generator, final_name, final_out=2):
        super().__init__()
        g = generator
        self.conv_0 = L.ConvBlock(in_channels, 128, 3, g)
        self.conv0_skip = L.ConvBlock(128, 96, 1, g, bias=False)
        self.conv_1 = L.ConvBlock(128, 128, 3, g)
        self.conv_2 = L.ConvBlock(128, 96, 3, g)
        self.conv2_skip = L.ConvBlock(96, 32, 1, g, bias=False)
        self.conv_3 = L.ConvBlock(96, 64, 3, g)
        self.conv_4 = L.ConvBlock(64, 32, 3, g)
        self.final_name = final_name
        setattr(self, final_name, L.conv2d(32, final_out, 3, g))

    def forward(self, x):
        """Returns (features before the head [b,32,h,w], head output [b,2,h,w])."""
        x0 = self.conv_0(x, relu=False)
        x2 = self.conv_2(self.conv_1(L.lrelu(x0)), relu=False)
        x2s = x2 + self.conv0_skip(x0, padding=0, relu=False)
        x4 = self.conv_4(self.conv_3(L.lrelu(x2s)), relu=False)
        x4s = x4 + self.conv2_skip(x2s, padding=0, relu=False)
        xo = L.lrelu(x4s)
        return xo, L.conv_plain(getattr(self, self.final_name), xo)


# --------------------------------------------------- PWC-Net refinement

def refinement_convs(in_channels, generator):
    """The seven convs of the dilated context network; the reference keeps
    them as top-level attributes ``dc_conv1..7`` / ``l_dc_conv1..7``."""
    g = generator
    return [L.ConvBlock(in_channels, 128, 3, g), L.ConvBlock(128, 128, 3, g),
            L.ConvBlock(128, 128, 3, g), L.ConvBlock(128, 96, 3, g),
            L.ConvBlock(96, 64, 3, g), L.ConvBlock(64, 32, 3, g), L.conv2d(32, 2, 3, g)]


def refinement(convs, x):
    """Dilated context network (base_matching_net.py:379-411): returns
    (features [b,32,h,w], residual flow [b,2,h,w])."""
    for conv, dil in zip(convs[:6], (1, 2, 4, 8, 16, 1)):
        x = conv(x, padding=dil, dilation=dil)
    return x, L.conv_plain(convs[6], x)


# --------------------------------------------------- uncertainty heads

class MdnFromCorr(nn.Module):
    """MixtureDensityEstimatorFromCorr (output_all_channels_together=True)."""

    def __init__(self, search_size, generator, output_channels=6, in_channels=1):
        super().__init__()
        g = generator
        self.search_size = search_size
        self.conv_0 = L.ConvBlock(in_channels, 32, 3, g)
        self.conv_1 = L.ConvBlock(32, 32, 3, g)
        self.conv_2 = L.ConvBlock(32, 16, 3, g)
        self.predict_uncertainty = L.conv2d(16, output_channels, 3, g)

    def forward(self, corr):
        """corr [b, s*s, h, w] -> [b, out_ch, h, w]."""
        s = self.search_size
        b, _, h, w = corr.shape
        x = corr.permute(0, 2, 3, 1).reshape(b * h * w, 1, s, s)
        x = self.conv_0(x, padding=0)                       # 16 -> 14 / 9 -> 7
        if s == 16:
            x = L.maxpool2(x)                               # -> 7
        x = self.conv_1(x, padding=0)                       # -> 5
        x = self.conv_2(x, padding=0)                       # -> 3
        u = L.conv_plain(self.predict_uncertainty, x, padding=0)   # -> 1x1
        return u.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class MdnFromFlow(nn.Module):
    """MixtureDensityEstimatorFromUncertaintiesAndFlow
    (output_all_channels_together=False, 3 output channels)."""

    def __init__(self, in_channels, generator, output_channels=3):
        super().__init__()
        g = generator
        self.conv_0 = L.ConvBlock(in_channels, 32, 3, g)
        self.conv_1 = L.ConvBlock(32, 16, 3, g)
        self.predict_uncertainty_final = L.conv2d(16, output_channels, 3, g)

    def forward(self, x):
        """Returns (log_var [b,1,h,w], weights [b,2,h,w])."""
        u = L.conv_plain(self.predict_uncertainty_final, self.conv_1(self.conv_0(x)))
        return u[:, 0:1], u[:, 1:]


def constrain_large_log_var_map(var_min, var_max, large_log_var_map):
    """base_pdcnet.py:121-140 (var_min > 0 and var_max > 0 case)."""
    return torch.log(var_min + (var_max - var_min)
                     * torch.sigmoid(large_log_var_map - math.log(var_max)))


def estimate_probability_of_confidence_interval_of_mixture_density(
        weight_map, log_var_map, R=1.0, gaussian=False):
    """P_R of the (Laplace by default) mixture (mod_uncertainty.py:16-34)."""
    proba = torch.softmax(weight_map, dim=1)
    var = torch.exp(log_var_map)
    if gaussian:
        return torch.sum(proba * (1 - torch.exp(-R ** 2 / (2 * var))), dim=1, keepdim=True)
    return torch.sum(proba * (1 - torch.exp(-math.sqrt(2.0) * R / torch.sqrt(var))) ** 2,
                     dim=1, keepdim=True)
