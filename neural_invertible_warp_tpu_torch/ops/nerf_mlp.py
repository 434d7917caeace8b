"""NeRF field MLP as an ``nn.Module`` (port of neural_invertible_warp_tpu/ops/nerf_mlp.py).

Sub-modules are named after the reference torch state_dict: ``mlp_feat.i``
(trunk, default 8x256 with the skip concat at layer 4; the last layer emits
width+1 with channel 0 the density) and ``mlp_rgb.i`` (view-dependent head,
sigmoid). Init copies the JAX package's: TensorFlow-style Xavier-uniform
with gain sqrt(2), gain 1 on the density row and the last rgb layer, zero
biases (``tf_init``), or the torch ``Linear`` default bound 1/sqrt(in).

``compute_dtype="bfloat16"`` (off by default: the plain chain does not
round) computes each layer as the field kernels do under
``tpu.compute_dtype: bfloat16``: both operands of every layer product, in
the forward and in both backward products, rounded to bf16 (to nearest,
ties to even), products summed in the operands' own dtype; biases,
activations and the positional encoding unrounded. It is the plain version
of K2-K4 in that mode (ops/cuda/fused_pe.py).
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


_DENSITY_ACTIV = {
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "relu": torch.relu,
    "abs": torch.abs,
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
}


def density_activation(name, x):
    """``arch.density_activ`` applied to the density pre-activation (the
    JAX package's ``_DENSITY_ACTIV``); an unknown name raises ``KeyError``."""
    return _DENSITY_ACTIV[name](x)


def round_bf16(x):
    """x rounded to bf16 values (to nearest, ties to even), in x's dtype.
    A float64 x is rounded once, from its own value (a cast through fp32
    would round twice)."""
    if x.dtype != torch.float64:
        return x.to(torch.bfloat16).to(x.dtype)
    bits = x.view(torch.int64)   # keep 8 significant bits of 53
    odd = (bits >> 45) & 1
    return ((bits + (1 << 44) - 1 + odd) & ~((1 << 45) - 1)).view(torch.float64)


class _Bf16Linear(torch.autograd.Function):
    """F.linear with both operands rounded to bf16, and in the backward the
    cotangent rounded too before each product (the bias gradient is the
    unrounded cotangent's sum)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        xb, wb = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xb, wb)
        return F.linear(xb, wb, bias)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = round_bf16(g)
        dx = gb @ wb if ctx.needs_input_grad[0] else None
        dw = (gb.reshape(-1, gb.shape[-1]).t() @ xb.reshape(-1, xb.shape[-1])
              if ctx.needs_input_grad[1] else None)
        db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def _linear(compute_dtype):
    """The layer product of ``compute_dtype``: None or "float32" F.linear,
    "bfloat16" _Bf16Linear."""
    if compute_dtype in (None, "float32"):
        return F.linear
    if compute_dtype == "bfloat16":
        return _Bf16Linear.apply
    raise ValueError("tpu.compute_dtype must be float32 or bfloat16, not {!r}".format(
        compute_dtype))


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

    def encode(self, points_3D, ray_unit=None, progress=None, barf_c2f=None):
        """The MLP's inputs: (points and their PE [...,3+6 L_3D], unit ray
        and its PE [...,3+6 L_view] or None without view dependence)."""
        enc = positional_encoding_c2f(points_3D, self.L_3D, progress, barf_c2f)
        points_enc = torch.cat([points_3D, enc], dim=-1)
        if not self.view_dep:
            return points_enc, None
        ray_enc = positional_encoding_c2f(ray_unit, self.L_view, progress, barf_c2f)
        return points_enc, torch.cat([ray_unit, ray_enc], dim=-1)

    def forward_encoded(self, points_enc, view_enc=None, density_activ="softplus",
                        noise=None, compute_dtype=None):
        """The layers on encoded inputs -> (rgb [...,3], density [...]).
        ``noise`` [...] is added to the density before its activation;
        ``compute_dtype`` as in the module docstring."""
        linear = _linear(compute_dtype)
        feat = points_enc
        density = None
        n_feat = len(self.mlp_feat)
        for li, lin in enumerate(self.mlp_feat):
            if li in self.skip:
                feat = torch.cat([feat, points_enc], dim=-1)
            feat = linear(feat, lin.weight, lin.bias)
            if li == n_feat - 1:
                density = feat[..., 0]
                if noise is not None:
                    density = density + noise
                density = density_activation(density_activ, density)
                feat = feat[..., 1:]
            feat = torch.relu(feat)
        if self.view_dep:
            feat = torch.cat([feat, view_enc], dim=-1)
        n_rgb = len(self.mlp_rgb)
        for li, lin in enumerate(self.mlp_rgb):
            feat = linear(feat, lin.weight, lin.bias)
            if li != n_rgb - 1:
                feat = torch.relu(feat)
        return torch.sigmoid(feat), density

    def forward(self, points_3D, ray_unit=None, progress=None, barf_c2f=None,
                density_activ="softplus", noise=None, compute_dtype=None):
        """points_3D, ray_unit: [...,3] -> (rgb [...,3], density [...]).
        ``noise`` [...]: the density-noise regularizer's draw, already scaled
        by ``nerf.density_noise_reg``, added before the density activation."""
        points_enc, view_enc = self.encode(points_3D, ray_unit, progress, barf_c2f)
        return self.forward_encoded(points_enc, view_enc, density_activ, noise,
                                    compute_dtype)


def sample_points(center, ray, depth_samples):
    """(points [B,R,K,3], unit rays [B,R,K,3]) of center/ray [B,R,3] at
    depth [B,R,K,1]."""
    points = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True),
                                 min=1e-12)
    return points, ray_unit[..., None, :].expand(points.shape)


def apply_nerf_samples(mlp, center, ray, depth_samples, **kwargs):
    """Field along rays. center/ray [B,R,3]; depth [B,R,K,1] ->
    rgb [B,R,K,3], density [B,R,K]. ``noise`` [B,R,K] and ``compute_dtype``
    (NerfMLP's) optional."""
    points, ray_unit = sample_points(center, ray, depth_samples)
    return mlp(points, ray_unit, **kwargs)
