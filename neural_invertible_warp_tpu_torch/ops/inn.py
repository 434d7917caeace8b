"""Invertible deformation network (port of neural_invertible_warp_tpu/ops/inn.py).

RealNVP/NDR-style coupling blocks, axis-cycled by ``form=(i//3)%2``,
``mode=i%3``. Per block: the focus coordinate is shifted by MLP_a of the
embedded other two coordinates and the block's latent code; then the other
two get an inverse 2-D rigid transform whose (theta, du, dv) come from
MLP_b of the embedded new focus coordinate. Hidden layers use weight norm
with explicit (v, g, b) parameters; output layers start at zero, so the
warp starts as the identity. Parameter names follow the reference
state_dict: ``lin{b}_a_{l}``, ``lin{b}_b_{l}``, ``lin{b}_c``.
``inverse`` runs the blocks in reverse with the exact algebraic inverses.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .posenc import annealed_embed, annealed_embed_reference

# (focus_axis, other_axes) per (form, mode)
_AXES = {
    (0, 0): (2, (0, 1)),
    (0, 1): (1, (0, 2)),
    (0, 2): (0, (1, 2)),
    (1, 0): (0, (1, 2)),
    (1, 1): (1, (0, 2)),
    (1, 2): (2, (0, 1)),
}


def _activation(name):
    if name == "softplus":     # beta = 100
        return lambda x: torch.logaddexp(100.0 * x, torch.zeros_like(x)) / 100.0
    if name == "silu":
        return F.silu
    if name == "elu":
        return F.elu
    if name == "relu":
        return torch.relu
    if name == "sine":
        return lambda x: torch.sin(10.0 * x)
    if name == "gaussian":
        return lambda x: torch.exp(-0.5 * x ** 2)
    raise ValueError("unknown INN activation: {}".format(name))


class WNLinear(nn.Module):
    """Weight-normalized linear layer: W = v * g / ||v||_row."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.weight_v = nn.Parameter(torch.zeros(d_out, d_in))
        self.weight_g = nn.Parameter(torch.zeros(d_out, 1))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        norm = torch.linalg.norm(self.weight_v, dim=1, keepdim=True)
        w = self.weight_v * (self.weight_g / torch.clamp(norm, min=1e-12))
        return F.linear(x, w, self.bias)


class DeformNetwork(nn.Module):

    def __init__(self, d_feature, d_hidden=128, n_blocks=3, n_layers=1,
                 multires=6, actfn="softplus", anneal="reference",
                 generator=None):
        super().__init__()
        self.n_blocks = n_blocks
        self.n_layers = n_layers
        self.multires = multires
        self.actfn = actfn
        self.act = _activation(actfn)
        self.anneal = anneal
        for b in range(n_blocks):
            for l, lin in enumerate(self._branch(2, d_feature, d_hidden,
                                                 n_layers, 1, generator)):
                self.add_module("lin{}_a_{}".format(b, l), lin)
            for l, lin in enumerate(self._branch(1, d_feature, d_hidden, 1, 3,
                                                 generator)):
                self.add_module("lin{}_b_{}".format(b, l), lin)
            lin_c = nn.Linear(d_feature, d_feature)
            with torch.no_grad():
                lin_c.weight.zero_()
                lin_c.bias.zero_()
            self.add_module("lin{}_c".format(b), lin_c)

    def _branch(self, ori_in, d_feature, d_hidden, n_layers, d_out, generator):
        """[PE(coords) ++ latent] -> hidden^n -> d_out. The first hidden
        layer is N(0, sqrt(2/d_hidden)) on the raw-coordinate columns only;
        the output layer is zero."""
        pe_dim = ori_in * (1 + 2 * self.multires) if self.multires > 0 else ori_in
        dims = [pe_dim + d_feature] + [d_hidden] * n_layers + [d_out]
        layers = []
        for l in range(len(dims) - 1):
            k_in, k_out = dims[l], dims[l + 1]
            if l == len(dims) - 2:
                lin = nn.Linear(k_in, k_out)
                with torch.no_grad():
                    lin.weight.zero_()
                    lin.bias.zero_()
            else:
                lin = WNLinear(k_in, k_out)
                std = math.sqrt(2.0) / math.sqrt(k_out)
                with torch.no_grad():
                    cols = ori_in if (l == 0 and self.multires > 0) else k_in
                    lin.weight_v[:, :cols].normal_(0.0, std, generator=generator)
                    lin.weight_g.copy_(torch.linalg.norm(lin.weight_v, dim=1,
                                                         keepdim=True))
            layers.append(lin)
        return layers

    def _embed(self, x, alpha_ratio):
        if self.multires <= 0:
            return x
        if self.anneal == "reference":
            return annealed_embed_reference(x, self.multires, alpha_ratio)
        return annealed_embed(x, self.multires, alpha_ratio)

    def _mlp(self, prefix, n_hidden, h):
        for l in range(n_hidden):
            h = self.act(getattr(self, "{}_{}".format(prefix, l))(h))
        return getattr(self, "{}_{}".format(prefix, n_hidden))(h)

    def _split(self, b, code, x):
        """(focus axis, other axes, latent rows [B,N,D], focus [B,N,1], other
        [B,N,2]) of block b."""
        focus_ax, other_ax = _AXES[((b // 3) % 2, b % 3)]
        code_b = getattr(self, "lin{}_c".format(b))(code) + code     # [B,D]
        code_n = code_b[:, None, :].expand(x.shape[:-1] + code_b.shape[-1:])
        focus = x[..., focus_ax:focus_ax + 1]
        other = torch.stack([x[..., other_ax[0]], x[..., other_ax[1]]], -1)
        return focus_ax, other_ax, code_n, focus, other

    @staticmethod
    def _join(focus_ax, other_ax, focus, other):
        cols = [None, None, None]
        cols[focus_ax] = focus[..., 0]
        cols[other_ax[0]] = other[..., 0]
        cols[other_ax[1]] = other[..., 1]
        return torch.stack(cols, dim=-1)

    def forward(self, code, pts, alpha_ratio):
        """Warp points forward. code: [B,D]; pts: [B,N,3] -> [B,N,3]."""
        x = pts
        for b in range(self.n_blocks):
            focus_ax, other_ax, code_n, focus, other = self._split(b, code, x)
            h = torch.cat([self._embed(other, alpha_ratio), code_n], dim=-1)
            focus = focus - self._mlp("lin{}_a".format(b), self.n_layers, h)
            h = torch.cat([self._embed(focus, alpha_ratio), code_n], dim=-1)
            out = self._mlp("lin{}_b".format(b), 1, h)
            theta, trans = out[..., 0], out[..., 1:3]
            c, s = torch.cos(theta), torch.sin(theta)
            o = other - trans
            other = torch.stack([c * o[..., 0] + s * o[..., 1],
                                 -s * o[..., 0] + c * o[..., 1]], dim=-1)
            x = self._join(focus_ax, other_ax, focus, other)
        return x

    def inverse(self, code, pts, alpha_ratio):
        """The exact inverse warp: the blocks in reverse, part b (the 2-D
        rigid transform, forward this time) before part a (the shift added
        back). code: [B,D]; pts: [B,N,3] -> [B,N,3]."""
        x = pts
        for b in reversed(range(self.n_blocks)):
            focus_ax, other_ax, code_n, focus, other = self._split(b, code, x)
            h = torch.cat([self._embed(focus, alpha_ratio), code_n], dim=-1)
            out = self._mlp("lin{}_b".format(b), 1, h)
            theta, trans = out[..., 0], out[..., 1:3]
            c, s = torch.cos(theta), torch.sin(theta)
            other = torch.stack([c * other[..., 0] - s * other[..., 1],
                                 s * other[..., 0] + c * other[..., 1]], dim=-1) + trans
            h = torch.cat([self._embed(other, alpha_ratio), code_n], dim=-1)
            focus = focus + self._mlp("lin{}_a".format(b), self.n_layers, h)
            x = self._join(focus_ax, other_ax, focus, other)
        return x


def deform_forward(net, code, pts, alpha_ratio):
    """Functional alias of ``DeformNetwork.forward``, named as in the JAX package."""
    return net(code, pts, alpha_ratio)


def deform_inverse(net, code, pts, alpha_ratio):
    """Functional alias of ``DeformNetwork.inverse``."""
    return net.inverse(code, pts, alpha_ratio)
