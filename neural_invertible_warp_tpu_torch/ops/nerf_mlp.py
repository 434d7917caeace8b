"""NeRF field MLP as an ``nn.Module`` (port of neural_invertible_warp_tpu/ops/nerf_mlp.py).

Sub-modules are named after the reference torch state_dict: ``mlp_feat.i``
(trunk, default 8x256 with the skip concat at layer 4; the last layer emits
width+1 with channel 0 the density) and ``mlp_rgb.i`` (view-dependent head,
sigmoid). Init copies the JAX package's: TensorFlow-style Xavier-uniform
with gain sqrt(2), gain 1 on the density row and the last rgb layer, zero
biases (``tf_init``), or the torch ``Linear`` default bound 1/sqrt(in).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .posenc import positional_encoding_c2f


def layer_dims(layers):
    """[None,256,...] -> [(in,out), ...]."""
    return list(zip(layers[:-1], layers[1:]))


def density_activation(name, x):
    if name == "softplus":
        return torch.logaddexp(x, torch.zeros_like(x))
    if name == "relu":
        return torch.relu(x)
    raise NotImplementedError(
        "density_activ {!r} is not ported yet (ROADMAP M11)".format(name))


def _xavier_(weight, gain, generator):
    """torch.nn.init.xavier_uniform_ on an [out, in] block."""
    n_out, n_in = weight.shape
    bound = gain * math.sqrt(6.0 / (n_out + n_in))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


class NerfMLP(nn.Module):

    def __init__(self, arch, view_dep=True, generator=None):
        super().__init__()
        self.arch = arch
        self.view_dep = view_dep
        self.L_3D = arch.posenc.L_3D
        self.L_view = arch.posenc.L_view
        self.skip = list(arch.skip)
        in_3D = 3 + 6 * self.L_3D
        in_view = (3 + 6 * self.L_view) if view_dep else 0
        tf_init = bool(arch.get("tf_init", False))
        self.mlp_feat = nn.ModuleList()
        dims = layer_dims(arch.layers_feat)
        for li, (k_in, k_out) in enumerate(dims):
            if li == 0:
                k_in = in_3D
            if li in self.skip:
                k_in += in_3D
            last = li == len(dims) - 1
            if last:
                k_out += 1     # channel 0 is the density
            lin = nn.Linear(k_in, k_out)
            self._init(lin, tf_init, generator,
                       gains=[1.0, math.sqrt(2.0)] if last else [math.sqrt(2.0)])
            self.mlp_feat.append(lin)
        self.mlp_rgb = nn.ModuleList()
        dims = layer_dims(arch.layers_rgb)
        for li, (k_in, k_out) in enumerate(dims):
            if li == 0:
                k_in = arch.layers_feat[-1] + in_view
            lin = nn.Linear(k_in, k_out)
            gain = 1.0 if li == len(dims) - 1 else math.sqrt(2.0)
            self._init(lin, tf_init, generator, gains=[gain])
            self.mlp_rgb.append(lin)

    @staticmethod
    def _init(lin, tf_init, generator, gains):
        with torch.no_grad():
            lin.bias.zero_()
            if not tf_init:
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=generator)
            elif len(gains) == 2:      # density row at gain 1, features at sqrt(2)
                _xavier_(lin.weight[:1], gains[0], generator)
                _xavier_(lin.weight[1:], gains[1], generator)
            else:
                _xavier_(lin.weight, gains[0], generator)

    def forward(self, points_3D, ray_unit=None, progress=None, barf_c2f=None,
                density_activ="softplus"):
        """points_3D, ray_unit: [...,3] -> (rgb [...,3], density [...])."""
        enc = positional_encoding_c2f(points_3D, self.L_3D, progress, barf_c2f)
        points_enc = torch.cat([points_3D, enc], dim=-1)
        feat = points_enc
        density = None
        n_feat = len(self.mlp_feat)
        for li, lin in enumerate(self.mlp_feat):
            if li in self.skip:
                feat = torch.cat([feat, points_enc], dim=-1)
            feat = F.linear(feat, lin.weight, lin.bias)
            if li == n_feat - 1:
                density = density_activation(density_activ, feat[..., 0])
                feat = feat[..., 1:]
            feat = torch.relu(feat)
        if self.view_dep:
            ray_enc = positional_encoding_c2f(ray_unit, self.L_view, progress,
                                              barf_c2f)
            feat = torch.cat([feat, ray_unit, ray_enc], dim=-1)
        n_rgb = len(self.mlp_rgb)
        for li, lin in enumerate(self.mlp_rgb):
            feat = F.linear(feat, lin.weight, lin.bias)
            if li != n_rgb - 1:
                feat = torch.relu(feat)
        return torch.sigmoid(feat), density


def apply_nerf_samples(mlp, center, ray, depth_samples, **kwargs):
    """Field along rays. center/ray [B,R,3]; depth [B,R,K,1] ->
    rgb [B,R,K,3], density [B,R,K]."""
    points = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                                 min=1e-12)
    ray_unit = ray_unit[..., None, :].expand(points.shape)
    return mlp(points, ray_unit, **kwargs)
