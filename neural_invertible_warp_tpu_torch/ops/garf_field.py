"""GARF field: the Gaussian-activation NeRF with no positional encoding, as
an ``nn.Module`` (port of neural_invertible_warp_tpu/ops/garf_field.py).

Children carry the reference's names (model/nerf_gaussian.py:334-457):
``gaussian_linear_d`` and ``gaussian_linear_c`` lift points and unit rays
to ``width`` and take the mean-centred Gaussian exp(-0.5 (mean(h) - h)^2 /
sigma^2); ``pts_linears`` is the Gaussian-activated trunk, the lifted points
concatenated after the activation of each layer in ``arch.skip`` (so the
next layer takes 2 width); with view dependence ``alpha_linear``,
``feature_linear``, ``views_linears`` (one Gaussian layer of width/2 on the
feature and the lifted ray) and ``rgb_linear``, else ``output_linear``
(rgb and density in one layer). Init: torch's default ``Linear`` bound
U(+-1/sqrt(fan_in)) for weight and bias, drawn from an explicit generator,
or the weight U(+-``init.weight.range``) when ``init.weight.uniform`` is set.
No kernel covers this field: the render core takes the plain chain for it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .nerf_mlp import density_activation, sample_points


def linear_layer(k_in, k_out, generator, uniform_range=None):
    """``nn.Linear`` with torch's default init drawn from ``generator``:
    weight and bias U(+-1/sqrt(k_in)), or the weight U(+-uniform_range)."""
    lin = nn.Linear(k_in, k_out)
    bound = 1.0 / math.sqrt(k_in)
    with torch.no_grad():
        w_bound = uniform_range if uniform_range is not None else bound
        lin.weight.uniform_(-w_bound, w_bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class GaussianNerf(nn.Module):

    def __init__(self, arch, view_dep=True, init_cfg=None, generator=None):
        super().__init__()
        self.arch = arch
        self.view_dep = view_dep
        self.sigma = float(arch.gaussian.sigma)
        self.skip = list(arch.skip)
        width, depth = arch.width, arch.depth
        ur = None
        if init_cfg and init_cfg.get("weight") and init_cfg.weight.get("uniform"):
            ur = init_cfg.weight.range

        def lin(k_in, k_out):
            return linear_layer(k_in, k_out, generator, ur)
        self.gaussian_linear_d = lin(3, width)
        self.gaussian_linear_c = lin(3, width)
        self.pts_linears = nn.ModuleList([lin(width, width)] + [
            lin(2 * width if i in self.skip else width, width) for i in range(depth - 1)])
        if view_dep:
            self.feature_linear = lin(width, width)
            self.alpha_linear = lin(width, 1)
            self.views_linears = nn.ModuleList([lin(2 * width, width // 2)])
            self.rgb_linear = lin(width // 2, 3)
        else:
            self.output_linear = lin(width, 4)

    def _gauss(self, x):
        return torch.exp(-0.5 * x ** 2 / self.sigma ** 2)

    def _lift(self, lin, x):
        """exp(-0.5 (mean(h) - h)^2 / sigma^2) of h = lin(x)."""
        h = F.linear(x, lin.weight, lin.bias)
        mu = torch.mean(h, dim=-1, keepdim=True)
        return self._gauss(mu - h)

    def forward(self, points_3D, ray_unit=None, density_activ="softplus", noise=None):
        """points_3D, ray_unit: [...,3] -> (rgb [...,3], density [...]).
        ``noise`` [...], the density noise already scaled by
        ``nerf.density_noise_reg``, is added to the density pre-activation."""
        feat = self._lift(self.gaussian_linear_d, points_3D)
        points_enc = feat
        for i, lin in enumerate(self.pts_linears):
            feat = self._gauss(F.linear(feat, lin.weight, lin.bias))
            if i in self.skip:
                feat = torch.cat([points_enc, feat], dim=-1)
        if self.view_dep:
            if ray_unit is None:
                raise ValueError("a view-dependent field needs ray_unit")
            alpha = F.linear(feat, self.alpha_linear.weight, self.alpha_linear.bias)
            feature = F.linear(feat, self.feature_linear.weight, self.feature_linear.bias)
            h = torch.cat([feature, self._lift(self.gaussian_linear_c, ray_unit)], dim=-1)
            for lin in self.views_linears:
                h = self._gauss(F.linear(h, lin.weight, lin.bias))
            rgb = F.linear(h, self.rgb_linear.weight, self.rgb_linear.bias)
        else:
            out = F.linear(feat, self.output_linear.weight, self.output_linear.bias)
            rgb, alpha = out[..., :3], out[..., 3:]
        if self.arch.get("sigmoid"):
            rgb = torch.sigmoid(rgb)
        if noise is not None:
            alpha = alpha + noise[..., None]
        return rgb, density_activation(density_activ, alpha)[..., 0]


def apply_gaussian_nerf_samples(field, center, ray, depth_samples, noise=None,
                                density_activ="softplus"):
    """The field along rays: center/ray [B,R,3], depth [B,R,K,1] -> rgb
    [B,R,K,3], density [B,R,K]; the unit rays are clipped at 1e-12."""
    points, ray_unit = sample_points(center, ray, depth_samples)
    return field(points, ray_unit if field.view_dep else None, density_activ, noise)
